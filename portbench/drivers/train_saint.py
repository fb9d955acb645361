"""``train_saint``: the GraphSAINT subgraph training loop with the mix's
sampler and TrainConfig. Set-up drives the loop's own call through steps
1-3, three epochs of one subgraph each (the window's captured step and
feed), which the reference follows, drawing the three subgraphs again from
the sampler's seed (``portbench/reference/saint.py``); then a warm-up epoch
of ``warmup_steps`` subgraphs. The window is one call over the window's
epochs at ``steps`` subgraphs an epoch. The traced run also times the
loop's host work for a subgraph (the sampler's iterator, then the layout
at the loop's edge budget) after the window."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np

from portbench.lib.cells import (Outcome, Quiet, Run, first_gradient, memory_peak, params, phase,
                                 release, run_dir, seeds, setup, sync, train_state,
                                 training_check, window_units)
from portbench.lib.trace import Window
from portbench.lib.work import Work
from portbench.reference.saint import Sampler as RefSampler


def _recording_sampler():
    from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler

    class Recording(GraphSaintRandomWalkSampler):
        """The program's sampler, counting the live nodes and edges of each
        subgraph it hands out (the window's work)."""

        sizes: List[Tuple[int, int]]

        def _collate(self, nodes, eids):
            self.sizes.append((len(nodes), len(eids)))
            return super()._collate(nodes, eids)

    return Recording


def drive(run: Run) -> Outcome:
    from ampnet_tpu_torch.core.config import TrainConfig
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.train import train_saint
    from ampnet_tpu_torch.train.loop import _saint_layout_budget

    phases: Dict[str, float] = {}
    phase(run, phases, "imported")
    s = seeds(run.seed)
    st = setup(run, s)
    phase(run, phases, "model")
    sp = run.traffic["sampler"]
    d = st.data
    sampler_seed = s["sampler"] % 2**62
    sampler = _recording_sampler()(
        d.x, d.edge_index, y=d.y, train_mask=d.train_mask, val_mask=d.val_mask,
        test_mask=d.test_mask, batch_size=sp["roots"], walk_length=sp["walk_length"],
        num_steps=1, sample_coverage=sp["coverage"], seed=sampler_seed)
    sampler.sizes = []
    tcfg = TrainConfig(**run.traffic["train"], seed=s["noise"] % 2**63, run_dir=run_dir(run),
                       epochs=1)
    state = train_state(st.model, tcfg)
    gen0 = state.generator.get_state().clone()
    quiet = Quiet()

    def call(steps: int, epochs: int):
        sampler.num_steps = steps
        return train_saint(st.model, sampler, st.graph,
                           dataclasses.replace(tcfg, epochs=epochs), log=quiet, state=state)

    losses = [call(1, 1)["history"][0]["loss"]]
    grad = {k: v.clone() for k, v in first_gradient(state).items()}
    losses += [call(1, 1)["history"][0]["loss"] for _ in range(2)]
    after3 = params(st.model)
    phase(run, phases, "first_steps")

    call(run.traffic["warmup_steps"], 1)
    epochs = window_units(run)
    phase(run, phases, "warmed")

    sampler.sizes = []
    release(run.device, empty=False)
    with Window(run.trace) as w:
        t0 = time.perf_counter()
        setup_s = time.time() - run.started
        call(sp["steps"], epochs)
        sync(run.device)
        window = time.perf_counter() - t0
    peak = memory_peak(run.device)
    steps = len(sampler.sizes)
    g = run.config["graph"]
    evals = (epochs if tcfg.select_best_every else 0) + 1
    work = Work(steps=list(sampler.sizes),
                forwards=[(g["nodes"], g["directed_edges"])] * (evals * tcfg.num_eval_samples))
    host = {}
    if run.trace:
        sampler.num_steps = run.traffic["host_timed_subgraphs"]
        budget = _saint_layout_budget(sampler)
        t = time.perf_counter()
        for sub in sampler:
            compute_layout(sub, edges_per_tile=budget)
        host["saint_host_ms"] = (time.perf_counter() - t) * 1e3 / sampler.num_steps
    del state
    st.model = st.graph = None
    release(run.device)

    rs = RefSampler(d.edge_index, g["nodes"], sp["roots"], sp["walk_length"], sp["coverage"],
                    sampler_seed)
    graphs = []
    for nodes, eids, pad_nodes, pad_edges in rs.draw(3):
        relabel = np.full(g["nodes"], -1, np.int64)
        relabel[nodes] = np.arange(len(nodes))
        graphs.append(run.ref.padded(
            d.x[nodes], relabel[d.edge_index[:, eids]], d.y[nodes], d.train_mask[nodes],
            d.val_mask[nodes], d.test_mask[nodes], rs.node_norm[nodes], pad_nodes, pad_edges,
            *st.stats, run.device))
    readings, versus = training_check(run, st, graphs, gen0, "saint_mean", losses, grad, after3)
    return Outcome({"setup_s": setup_s, "saint_step_ms": window * 1e3 / steps}, work,
                   readings, peak, w.trace, host, attempted=steps, versus=versus, phases=phases)
