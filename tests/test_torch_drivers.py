"""The port's drivers (``ampnet_tpu_torch/experiments``) and graft entry
(``ampnet_tpu_torch/graft_entry.py``) against the JAX package's
``experiments/`` and ``__graft_entry__.py``.

For every flag set, each port driver builds the same model config,
training config and sampler arguments as its JAX driver: both sides'
``train_full_batch`` / ``train_saint``, ``cora_graph`` and sampler are
replaced by recorders. Then each port driver runs end to end on the CPU for
2 epochs on a 200-node induced subgraph of the Cora surrogate, writing its
run dir, history.csv and plots. The graft entry's graph equals JAX's
``_flagship()`` graph, and its log-probs equal JAX's at the same params and
``sampled_idx`` (rtol 1e-4 / atol 2e-4: f32 sums in another order).

The JAX drivers and ``__graft_entry__`` turn on JAX's persistent
compilation cache when imported; ``AMPNET_JAX_CACHE`` points it into a
temporary directory first, and afterwards the JAX config is restored and
the modules are dropped from ``sys.modules``.
"""
import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import TrainConfig, replace
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.data.planetoid import PlanetoidData, synthetic_cora
from ampnet_tpu_torch.experiments import common
from ampnet_tpu_torch.experiments import contrastive_ssl_AMPNet as port_ssl
from ampnet_tpu_torch.experiments import cora_benchmark_full as port_full
from ampnet_tpu_torch.experiments import cora_benchmark_graphsaint as port_saint
from ampnet_tpu_torch.experiments import visualize_cora_attn_coeffs as port_attn
from ampnet_tpu_torch.graft_entry import entry

ROOT = Path(__file__).resolve().parents[1]
CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX drivers and graft entry, imported with the compile cache in a
    temporary directory; the JAX config restored after the module."""
    saved = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    env = os.environ.get("AMPNET_JAX_CACHE")
    os.environ["AMPNET_JAX_CACHE"] = str(tmp_path_factory.mktemp("jax_cache"))
    sys.path.insert(0, str(ROOT / "experiments"))
    sys.path.insert(0, str(ROOT))
    try:
        import cora_benchmark_full
        import cora_benchmark_graphsaint
        import __graft_entry__

        yield dict(full=cora_benchmark_full, saint=cora_benchmark_graphsaint,
                   entry=__graft_entry__)
    finally:
        sys.path.remove(str(ROOT / "experiments"))
        sys.path.remove(str(ROOT))
        # a later import in this process runs their module code (the cache
        # set-up) again, under its own environment
        for name in ("cora_benchmark_full", "cora_benchmark_graphsaint", "common",
                     "__graft_entry__"):
            sys.modules.pop(name, None)
        if env is None:
            os.environ.pop("AMPNET_JAX_CACHE", None)
        else:
            os.environ["AMPNET_JAX_CACHE"] = env
        for k, v in saved.items():
            jax.config.update(k, v)


@pytest.fixture(scope="module")
def small_cora():
    """A 200-node induced subgraph of the surrogate, grown breadth-first from
    node 0 so that it keeps its edges: (data, padded graph)."""
    d = synthetic_cora(0)
    src, dst = d.edge_index
    keep, frontier = [0], [0]
    seen = {0}
    while len(keep) < 200:
        nxt = [int(v) for u in frontier for v in dst[src == u] if int(v) not in seen]
        nxt = list(dict.fromkeys(nxt)) or [int(np.setdiff1d(np.arange(d.num_nodes), keep)[0])]
        for v in nxt[: 200 - len(keep)]:
            seen.add(v)
            keep.append(v)
        frontier = nxt
    keep = np.array(keep)
    pos = np.full(d.num_nodes, -1)
    pos[keep] = np.arange(len(keep))
    m = (pos[src] >= 0) & (pos[dst] >= 0)
    sub = PlanetoidData(d.x[keep], d.y[keep], np.stack([pos[src[m]], pos[dst[m]]]),
                        d.train_mask[keep], d.val_mask[keep], d.test_mask[keep],
                        name="SyntheticCora200", synthetic=True)
    return sub, common_graph(sub)


def common_graph(d):
    return from_arrays(d.x, d.edge_index, y=d.y, train_mask=d.train_mask,
                       val_mask=d.val_mask, test_mask=d.test_mask,
                       node_norm=np.ones(d.num_nodes, np.float32))


class Recorder:
    """Takes the place of a training loop or a sampler: keeps what it is given."""

    def __init__(self):
        self.calls = []

    def train(self, model, data, *rest, log=None):
        self.calls.append((model, data, *rest))
        return {"history": []}

    def sampler(self, *args, **kwargs):
        self.calls.append(("sampler", args, kwargs))
        return "sampler"


def model_signature(model):
    """What a driver's model is made of: the config's fields (a port
    classifier's options), and whether it has dataset scaler stats."""
    if hasattr(model, "scaler_stats"):                           # a flax module
        stats = model.scaler_stats is not None
        if hasattr(model, "config"):
            return dataclasses.asdict(model.config), stats
        fields = {f.name: getattr(model, f.name) for f in dataclasses.fields(model)
                  if f.name not in ("parent", "name", "scaler_stats")}
        return dict(fields, scaler=stats), stats
    cfg = model.config
    if dataclasses.is_dataclass(cfg) and hasattr(cfg, "embedding_dim"):
        return dataclasses.asdict(cfg), model.scaler_mean is not None
    options = dict(cfg.options)
    return options, options["scaler"]


def train_signature(tcfg, run_base):
    assert Path(tcfg.run_dir).parent == Path(run_base)
    return dict(dataclasses.asdict(tcfg), run_dir=None)


def record(monkeypatch, module, data, loop):
    rec = Recorder()
    monkeypatch.setattr(module, "cora_graph", lambda: (data, "graph"))
    monkeypatch.setattr(module, loop, rec.train)
    monkeypatch.setattr(module, "plot_history", lambda history, path: None)
    if hasattr(module, "GraphSaintRandomWalkSampler"):
        monkeypatch.setattr(module, "GraphSaintRandomWalkSampler", rec.sampler)
    return rec


FULL_FLAGS = [dict(), dict(tuned=True), dict(raw_residual=True),
              dict(raw_residual=True, profile_steps=3, epochs_per_dispatch=5),
              dict(tuned=True, epochs=20, epochs_per_dispatch=4)]


@pytest.mark.parametrize("flags", FULL_FLAGS, ids=lambda f: "-".join(f) or "default")
def test_full_driver_builds_the_jax_configs(jax_side, small_cora, monkeypatch, tmp_path,
                                            flags):
    flags = dict(flags)
    epochs = flags.pop("epochs", 150)
    profile = flags.pop("profile_steps", 0)
    jrec = record(monkeypatch, jax_side["full"], small_cora[0], "train_full_batch")
    prec = record(monkeypatch, port_full, small_cora[0], "train_full_batch")
    jax_side["full"].main(epochs, run_base=str(tmp_path / "jax"), profile_steps=profile,
                          **flags)
    port_full.main(epochs, run_base=str(tmp_path / "port"), profile_steps=profile,
                   device="cpu", **flags)
    (jm, _, jt), (pm, _, pt) = jrec.calls[0], prec.calls[0]
    assert model_signature(pm) == model_signature(jm)
    assert train_signature(pt, tmp_path / "port") == train_signature(jt, tmp_path / "jax")


SAINT_FLAGS = [dict(), dict(stabilized=True, fused=True, raw_residual=True, decay_lr=True),
               dict(stabilized=True), dict(train_ampconv=False, stabilized=True),
               dict(fused=True, profile_steps=4)]


@pytest.mark.parametrize("flags", SAINT_FLAGS, ids=lambda f: "-".join(f) or "default")
def test_saint_driver_builds_the_jax_configs(jax_side, small_cora, monkeypatch, tmp_path,
                                             flags):
    jrec = record(monkeypatch, jax_side["saint"], small_cora[0], "train_saint")
    prec = record(monkeypatch, port_saint, small_cora[0], "train_saint")
    jax_side["saint"].main(12, 30, run_base=str(tmp_path / "jax"), **flags)
    port_saint.main(12, 30, run_base=str(tmp_path / "port"), device="cpu", **flags)
    (_, jargs, jkw), (_, pargs, pkw) = jrec.calls[0], prec.calls[0]
    assert len(jargs) == len(pargs) == 2 and jkw.keys() == pkw.keys()
    for a, b in zip((*jargs, *jkw.values()), (*pargs, *pkw.values())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert pkw["batch_size"] == 8 and pkw["walk_length"] == 150 and pkw["seed"] == 1
    (jm, js, _, jt), (pm, ps, _, pt) = jrec.calls[1], prec.calls[1]
    assert js == ps == "sampler"
    assert model_signature(pm) == model_signature(jm)
    assert train_signature(pt, tmp_path / "port") == train_signature(jt, tmp_path / "jax")


def test_config_replace_matches_jax():
    from ampnet_tpu.core.config import TrainConfig as JaxTrainConfig
    from ampnet_tpu.core.config import replace as jax_replace

    ours = replace(TrainConfig(), profile_steps=3, learning_rate=1e-3)
    ref = jax_replace(JaxTrainConfig(), profile_steps=3, learning_rate=1e-3)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    with pytest.raises(dataclasses.FrozenInstanceError):
        ours.epochs = 3


def test_cora_graph_pads_as_jax():
    d, g = common.cora_graph()
    assert g.x.shape == (2752, 1433) and g.senders.shape == (10624,)
    assert int(g.node_mask.sum()) == d.num_nodes and int(g.edge_mask.sum()) == 10556
    assert bool((g.node_norm[: d.num_nodes] == 1).all())


# ------------------------------------------------------------------ end to end, CPU


def test_full_driver_and_attention_heatmaps_end_to_end(small_cora, monkeypatch, tmp_path):
    """The recommended recipe's driver for 2 epochs (through main: run dir,
    checkpoints, history.csv, curves), then the attention driver on its
    final checkpoint."""
    d, g = small_cora
    monkeypatch.setattr(port_full, "cora_graph", lambda: (d, g))
    monkeypatch.setattr(port_attn, "cora_graph", lambda: (d, g))
    result = port_full.main(2, run_base=str(tmp_path / "runs"), raw_residual=True,
                            device="cpu")
    run = Path(result["run_dir"])
    assert len(result["history"]) == 2 and np.isfinite(result["final_metrics"]["test_acc"])
    for name in ("_details.txt", "history.csv", "loss_curves.png", "acc_curves.png",
                 "checkpoint_final.pkl"):
        assert (run / name).exists(), name
    heat = port_attn.main(str(run / "checkpoint_final.pkl"), str(tmp_path / "attn"),
                          stabilized=True, raw_residual="gcn2", device="cpu")
    assert set(heat) == set(port_attn.CLASS_PAIRS)
    for (cs, cd), h in heat.items():
        assert h.shape == (30, 30) and np.isfinite(h).all()
        assert (tmp_path / "attn" / f"attn_class{cs}_to_class{cd}_heatmap.png").exists()
    assert any(h.any() for h in heat.values())


def test_saint_driver_end_to_end(small_cora, monkeypatch, tmp_path):
    """The stabilized recipe with the fused op, the gcn2 head and one cosine
    cycle: 2 epochs of 2 subgraphs on the native sampler."""
    monkeypatch.setattr(port_saint, "cora_graph", lambda: small_cora)
    result = port_saint.main(2, 2, run_base=str(tmp_path / "runs"), fused=True,
                             stabilized=True, raw_residual=True, decay_lr=True,
                             device="cpu")
    run = Path(result["run_dir"])
    assert [row["epoch"] for row in result["history"]] == [0, 1]
    assert np.isfinite(result["final_metrics"]["test_acc"])
    for name in ("history.csv", "loss_curves.png", "checkpoint_final.pkl"):
        assert (run / name).exists(), name


@pytest.mark.parametrize("mode", ["contrastive", "predictive"])
def test_ssl_drivers_end_to_end(mode, capsys):
    state = port_ssl.train_model(2, mode=mode, device="cpu")
    assert state.step == 2 and state.model.mode == mode
    assert "epoch    0 | ssl loss" in capsys.readouterr().out


# ------------------------------------------------------------------ graft entry


def test_entry_forward_matches_jax_flagship(jax_side):
    """entry(): [768, 7] log-probs; the graph is JAX's _flagship() graph;
    with JAX's params and one sampled_idx the logits are JAX's."""
    fn, (g, gen) = entry(device="cpu")
    out = fn(g, gen)
    assert out.shape == (768, 7) and bool(torch.isfinite(out).all())
    assert fn.model.config.use_pallas is False
    jm, _, params, gj = jax_side["entry"]._flagship()
    for name in ("x", "senders", "receivers", "edge_mask", "node_mask", "y", "train_mask",
                 "node_norm"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(gj, name)),
                                      err_msg=name)
    fn.model.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    idx = np.random.default_rng(1).integers(0, 1433, (g.x.shape[0], 20))
    ref = jm.apply({"params": params}, gj, deterministic=True, sampled_idx=jnp.asarray(idx),
                   return_aux=False).logits
    with torch.no_grad():
        ours = fn.model(g, sampled_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-4)
