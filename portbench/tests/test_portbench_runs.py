"""Whole runs of every cell at a CPU size, without the harness's look for a
card: the program passes its own comparison; the control (the reference
in the precision below the configuration's, in the program's place) and
each fault a cell can have, planted in the program underneath the timed
path (for the full-batch cells also in the window's multi-step dispatch
alone), fail it."""
from __future__ import annotations

import json

import pytest
import torch

from portbench.lib import report

CELLS = ["cora-s40.train-full", "cora-s64-bf16.train-full", "cora-s40.eval-8draw",
         "cora-s40.train-saint"]
TRAINING = [c for c in CELLS if "train" in c]


def _checks(result) -> dict:
    return {k: (v["value"], v["limit"]) for k, v in result["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_and_is_correct(small_run, cell):
    """Correct at the CPU size too, where the configuration computes in
    float32; a bf16 configuration's limits are the card's (the CPU's plain
    bf16 path rounds elsewhere than the kernels), so there only the run and
    its result are checked."""
    run, m = small_run(cell)
    result, _ = report.execute(run, m)
    if run.config["precision"] == "float32":
        assert result["correct"], _checks(result)
    assert all(0 <= c["value"] < 1 for c in result["checks"].values()), _checks(result)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {x["name"] for x in m.end_to_end(cell)}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    json.dumps(result)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_per_layer_metrics(small_run, cell):
    """On the CPU the trace holds no device operation: the device metrics
    read nothing and are left out, the others are there."""
    run, m = small_run(cell, trace=True)
    result, _ = report.execute(run, m)
    assert result["correct"] or run.config["precision"] != "float32"
    names = set(result["metrics"])
    assert names <= {x["name"] for x in m.per_layer(cell)}
    assert any(n.startswith("mfu.") for n in names)
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    if cell.endswith("train-saint"):
        assert result["metrics"]["saint_host_ms"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(small_run, cell):
    """The reference computed a step below the configuration's precision
    (TF32 products for float32, fp8 convs for bfloat16), put in the
    program's place, exceeds a limit."""
    run, m = small_run(cell, seed=7)
    outcome = m.driver(run.traffic["entry"])(run)
    readings = outcome.versus(run.ref.control_of(run.config))
    limits = run.cell_data["limits"]
    assert any(readings[k] > limit for k, limit in limits.items()), readings


def _state_unchanged(monkeypatch):
    from ampnet_tpu_torch.train import optim

    def step(self, lr=None):
        self.count += 1

    monkeypatch.setattr(optim.Optimizer, "step", step)


def _half_the_batch(monkeypatch):
    from ampnet_tpu_torch.train import losses, state

    def half(mask):
        """Every second node of the mask left out."""
        return mask & (torch.cumsum(mask.long(), 0) % 2 == 1)

    for name, fn in (("masked_mean_nll", losses.masked_mean_nll),
                     ("saint_weighted_mean_nll", losses.saint_weighted_mean_nll)):
        if name == "masked_mean_nll":
            monkeypatch.setattr(state, name, lambda lp, y, mask, fn=fn: fn(lp, y, half(mask)))
        else:
            monkeypatch.setattr(state, name,
                                lambda lp, y, nn, mask, fn=fn: fn(lp, y, nn, half(mask)))


def _answer_altered(monkeypatch):
    """The first training node's log-probs shifted by 1 where the model
    produces them."""
    from ampnet_tpu_torch.models import amp_gcn

    forward = amp_gcn.AMPGCN.forward

    def altered(self, graph, *args, **kwargs):
        out = forward(self, graph, *args, **kwargs)
        node = torch.nonzero(graph.train_mask & graph.node_mask)[0, 0]
        shift = torch.zeros_like(out)
        shift[node] = 1.0
        return out + shift

    monkeypatch.setattr(amp_gcn.AMPGCN, "forward", altered)


def _dispatch_state_unchanged(monkeypatch):
    """The loop's multi-step dispatch (the window's captured program) hands
    back the parameters it started from; single steps are sound."""
    from ampnet_tpu_torch.train import loop

    make = loop.make_scan_train_step

    def broken(model, *args, **kwargs):
        inner = make(model, *args, **kwargs)

        def step(state, graph, layout=None):
            saved = [p.detach().clone() for p in model.parameters()]
            state, out = inner(state, graph, layout)
            with torch.no_grad():
                for p, v in zip(model.parameters(), saved):
                    p.copy_(v)
            return state, out

        return step

    monkeypatch.setattr(loop, "make_scan_train_step", broken)


FAULTS = {"state_unchanged": _state_unchanged, "half_the_batch": _half_the_batch,
          "answer_altered": _answer_altered, "dispatch_state_unchanged": _dispatch_state_unchanged}
ONLY = {"state_unchanged": TRAINING, "dispatch_state_unchanged": [c for c in TRAINING
                                                                  if "full" in c]}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS
                                        if c in ONLY.get(f, CELLS)])
def test_a_fault_fails_the_run(small_run, monkeypatch, cell, fault):
    run, m = small_run(cell, seed=5)
    FAULTS[fault](monkeypatch)
    result, _ = report.execute(run, m)
    assert not result["correct"], _checks(result)


def test_a_mix_with_a_run_dir_checkpoints_there(small_run, monkeypatch, tmp_path):
    """A mix's ``run_dir`` names a directory for the cell, emptied before
    the run; the loop writes its checkpoints there and the run is correct."""
    from portbench.lib import cells

    monkeypatch.setattr(cells, "RUNS", tmp_path)
    run, m = small_run("cora-s40.train-full")
    run.traffic["run_dir"] = "ckpt"
    stale = tmp_path / run.cell / "ckpt" / "stale.txt"
    stale.parent.mkdir(parents=True)
    stale.write_text("from another run")
    result, _ = report.execute(run, m)
    assert result["correct"], _checks(result)
    assert not stale.exists()
    assert list(stale.parent.glob("checkpoint_*.pkl"))
