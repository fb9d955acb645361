"""The port's remaining experiment drivers (``ampnet_tpu_torch/experiments``)
against the JAX package's ``experiments/``.

Config parity: for each driver, both sides' training loop (or the first
call that would start real work) is replaced by a recorder, both drivers
run with the same flags, and what they built is compared field by field:
model configs, training configs, optimizer settings, sampler and data
arguments. The recorders raise ``Stop`` where a driver would go on to
train, so no JAX model is initialized or trained. JAX's ``scaling_bench``,
``halo_comm_accounting``, ``halo_budget_run`` and
``partitioned_graph1_timing`` are read as source (their import sets
``XLA_FLAGS`` and ``jax_platforms``, or their ``main`` initializes a
model): their flags' defaults, model configs and shapes against the port's.

On given arrays, against JAX: ``find_checkpoint``'s choice, the seed
ensemble's accuracy, the LR schedule, the RPG generator's pickles. Then a
small end-to-end CPU run per group (Cora's 200-node induced subgraph, the
XOR graphs). The spawned-rank drivers are in
``tests/test_torch_experiments_parallel.py``.
"""
import ast
import dataclasses
import os
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.data.planetoid import PlanetoidData, synthetic_cora
from ampnet_tpu_torch.experiments import ampnet_freeze_check as port_freeze
from ampnet_tpu_torch.experiments import cora_benchmark_full as port_full
from ampnet_tpu_torch.experiments import cora_linear_layer_baseline as port_linear
from ampnet_tpu_torch.experiments import cora_overfit_one_subgraph as port_overfit
from ampnet_tpu_torch.experiments import cosine_lr_scheduler_test as port_cosine
from ampnet_tpu_torch.experiments import eval_checkpoint as port_eval
from ampnet_tpu_torch.experiments import grid_search as port_grid
from ampnet_tpu_torch.experiments import halo_budget_run as port_budget
from ampnet_tpu_torch.experiments import halo_comm_accounting as port_halo
from ampnet_tpu_torch.experiments import partitioned_graph1_timing as port_timing
from ampnet_tpu_torch.experiments import raw_residual_tuning as port_rr
from ampnet_tpu_torch.experiments import scaling_bench as port_scaling
from ampnet_tpu_torch.experiments import seed_ensemble as port_ensemble
from ampnet_tpu_torch.experiments import seed_robustness as port_robust
from ampnet_tpu_torch.experiments import synthetic_rgb_generate as port_rgb
from ampnet_tpu_torch.experiments import synthetic_training as port_mse
from ampnet_tpu_torch.experiments import synthetic_training_modular as port_stm
from ampnet_tpu_torch.experiments import synthetic_training_modular_graphsaint as port_stmg
from ampnet_tpu_torch.experiments import token_scale_tuning as port_ts
from ampnet_tpu_torch.experiments import transformer_tuning as port_tt

ROOT = Path(__file__).resolve().parents[1]
CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
JAX_DRIVERS = ("eval_checkpoint", "seed_robustness", "seed_ensemble", "raw_residual_tuning",
               "token_scale_tuning", "transformer_tuning", "synthetic_training_modular",
               "synthetic_training_modular_graphsaint", "grid_search", "ampnet_freeze_check",
               "synthetic_training", "synthetic_rgb_generate", "cora_overfit_one_subgraph",
               "cora_linear_layer_baseline", "cosine_lr_scheduler_test")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here and in the ranks this module spawns: the
    suite runs six workers on the host's cores, and these small steps pay
    for every thread they wait on."""
    saved, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(saved)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX drivers, imported with the compile cache in a temporary
    directory; the JAX config, sys.path and sys.modules restored after."""
    saved = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    env = os.environ.get("AMPNET_JAX_CACHE")
    os.environ["AMPNET_JAX_CACHE"] = str(tmp_path_factory.mktemp("jax_cache"))
    path = list(sys.path)
    sys.path.insert(0, str(ROOT / "experiments"))
    try:
        import importlib

        yield {name: importlib.import_module(name) for name in JAX_DRIVERS}
    finally:
        sys.path[:] = path
        for name in (*JAX_DRIVERS, "common"):
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
    node 0: (data, padded graph)."""
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
    g = from_arrays(sub.x, sub.edge_index, y=sub.y, train_mask=sub.train_mask,
                    val_mask=sub.val_mask, test_mask=sub.test_mask,
                    node_norm=np.ones(sub.num_nodes, np.float32))
    return sub, g


class Stop(Exception):
    """Raised by a recorder where a driver would start real work."""


class Rec:
    """Keeps every call's (args, kwargs); returns ``ret`` (a callable of the
    call: its result), or raises Stop from call ``stop_at`` on."""

    def __init__(self, ret=None, stop_at=None):
        self.calls, self.ret, self.stop_at = [], ret, stop_at

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        if self.stop_at is not None and len(self.calls) >= self.stop_at:
            raise Stop
        return self.ret(*args, **kwargs) if callable(self.ret) else self.ret


class Dummy:
    """A model stand-in: no config, no parameters."""

    config = None

    def parameters(self):
        return iter(())


def cfg_dict(model):
    """A model's config as a dict: a dataclass config's fields, or a flax
    module's fields / a port classifier's options."""
    cfg = model.config if hasattr(model, "config") else None
    if dataclasses.is_dataclass(cfg) and hasattr(cfg, "embedding_dim"):
        return dataclasses.asdict(cfg)
    if cfg is not None:                                     # a port classifier
        return dict(cfg.options)
    return {f.name: getattr(model, f.name) for f in dataclasses.fields(model)
            if f.name not in ("parent", "name", "pca_embedding")}


def argv(monkeypatch, script, *flags):
    monkeypatch.setattr(sys, "argv", [script, *flags])


# ------------------------------------------------------------- config parity


@pytest.mark.parametrize("flags", [[], ["--stabilized", "--raw-residual", "gcn2", "--fused"],
                                   ["--transformer-block", "--ensemble", "4", "--seed", "3"],
                                   ["--stabilized", "--raw-residual", "mlp"]],
                         ids=lambda f: "-".join(f) or "default")
def test_eval_checkpoint_builds_the_jax_config(jax_side, small_cora, monkeypatch, tmp_path,
                                               flags):
    import ampnet_tpu.models
    import ampnet_tpu.train.checkpoint
    import ampnet_tpu.train.loop
    import ampnet_tpu.train.state

    (tmp_path / "checkpoint_best.pkl").write_bytes(b"")
    seen = {"jax": [], "port": []}

    def fake_model(side):
        class Model:
            def __init__(self, config=None, scaler_stats=None, **kw):
                seen[side].append(("model", config, scaler_stats is not None))

            def load_state_dict(self, params):
                pass
        return Model

    def fake_eval(side, key_seed):
        def make(model, num_eval_samples=1):
            def ev(*args):
                seen[side].append(("eval", num_eval_samples, key_seed(args)))
                return {"val_acc": 0.5, "test_acc": 0.5}
            return ev
        return make

    jm = jax_side["eval_checkpoint"]
    monkeypatch.setattr(jm, "cora_graph", lambda: small_cora)
    monkeypatch.setattr(ampnet_tpu.models, "AMPGCN", fake_model("jax"))
    monkeypatch.setattr(ampnet_tpu.train.loop, "make_eval_step", fake_eval(
        "jax", lambda a: int(np.asarray(jax.random.key_data(a[2]))[-1])))
    monkeypatch.setattr(ampnet_tpu.train.state, "create_train_state",
                        lambda *a, **k: type("S", (), {"params": None}))
    monkeypatch.setattr(ampnet_tpu.train.checkpoint, "load_checkpoint_params", lambda *a: None)
    argv(monkeypatch, "eval_checkpoint.py", str(tmp_path), *flags)
    jm.main()

    monkeypatch.setattr(port_eval, "cora_graph", lambda: small_cora)
    monkeypatch.setattr(port_eval, "AMPGCN", fake_model("port"))
    monkeypatch.setattr(port_eval, "make_eval_step", fake_eval(
        "port", lambda a: a[1].initial_seed()))
    monkeypatch.setattr(port_eval, "load_checkpoint_params", lambda path: {})
    monkeypatch.setattr(port_eval, "compute_layout", lambda g: None)
    port_eval.main([str(tmp_path), *flags, "--device", "cpu"])

    (_, jcfg, jstats), jev = seen["jax"]
    (_, pcfg, pstats), pev = seen["port"]
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pstats == jstats and pev == jev


def test_find_checkpoint_chooses_as_jax(jax_side, tmp_path):
    find = jax_side["eval_checkpoint"].find_checkpoint
    for names in (["checkpoint_ep9.pkl", "checkpoint_ep19.pkl", "checkpoint_final.pkl"],
                  ["checkpoint_ep9.pkl", "checkpoint_ep100.pkl", "checkpoint_ep19.pkl"],
                  ["checkpoint_final.pkl", "checkpoint_best.pkl", "checkpoint_ep3.pkl"],
                  ["checkpoint_ep2.pkl"]):
        run = tmp_path / "-".join(names)
        run.mkdir()
        for n in names:
            (run / n).write_bytes(b"")
        assert port_eval.find_checkpoint(str(run)) == find(str(run))
        assert port_eval.find_checkpoint(str(run / names[0])) == str(run / names[0])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        port_eval.find_checkpoint(str(tmp_path / "empty"))


RECIPE_DRIVERS = [
    ("seed_robustness", port_robust, []),
    ("seed_robustness", port_robust, ["--raw-residual", "gcn2", "--dropout", "0.3",
                                      "--weight-decay", "1e-3", "--seeds", "4", "5"]),
    ("seed_robustness", port_robust, ["--transformer-block", "--dropout-adj", "0.2",
                                      "--lr", "1e-3", "--epochs", "7"]),
    ("seed_ensemble", port_ensemble, []),
    ("seed_ensemble", port_ensemble, ["--seeds", "3", "--epochs", "5", "--eval-draws", "2"]),
    ("raw_residual_tuning", port_rr, []),
    ("raw_residual_tuning", port_rr, ["--configs",
                                      "gcn_drop0.1_adj0.1_wd5e-4,mlp_drop0.1_adj0.1_wd5e-4",
                                      "--epochs", "9"]),
    ("token_scale_tuning", port_ts, []),
    ("token_scale_tuning", port_ts, ["--s", "20,40"]),
    ("transformer_tuning", port_tt, []),
    ("transformer_tuning", port_tt, ["--configs", "drop0.5_adj0.3_wd5e-4"]),
]


@pytest.mark.parametrize("name,port,flags", RECIPE_DRIVERS,
                         ids=lambda v: v if isinstance(v, str) else
                         ("-".join(v) or "default") if isinstance(v, list) else "")
def test_recipe_drivers_build_the_jax_configs(jax_side, small_cora, monkeypatch, name, port,
                                              flags):
    """Every train_full_batch call: the model config, the dataset scaler,
    the training config, the eval graph; the port's weights from the
    training seed."""
    jm = jax_side[name]
    sides = {}
    for side, mod in (("jax", jm), ("port", port)):
        # seed_ensemble goes on to evaluate its members: stop at the last one
        members = 1 if "--seeds" in flags else 3
        rec = Rec(ret={"final_metrics": {"val_acc": 0.5, "test_acc": 0.5},
                       "final_params": None},
                  stop_at=members if name == "seed_ensemble" else None)
        monkeypatch.setattr(mod, "train_full_batch", rec)
        monkeypatch.setattr(mod, "cora_graph", lambda: (small_cora[0], "graph"))
        sides[side] = rec
        if name == "seed_ensemble":
            if side == "jax":
                argv(monkeypatch, f"{name}.py", *flags)
                with pytest.raises(Stop):
                    jm.main()
            else:
                with pytest.raises(Stop):
                    port.main([*flags, "--device", "cpu"])
        elif side == "jax":
            argv(monkeypatch, f"{name}.py", *flags)
            jm.main()
        else:
            port.main([*flags, "--device", "cpu"])
    jcalls, pcalls = sides["jax"].calls, sides["port"].calls
    assert len(jcalls) == len(pcalls) > 0
    for (ja, jk), (pa, pk) in zip(jcalls, pcalls):
        jmodel, jg, jt = ja
        pmodel, pg, pt = pa
        assert cfg_dict(pmodel) == cfg_dict(jmodel)
        assert (pmodel.scaler_mean is not None) == (jmodel.scaler_stats is not None)
        assert dataclasses.asdict(pt) == dataclasses.asdict(jt)
        assert jg == pg == jk["eval_graph"] == pk["eval_graph"] == "graph"
        if name.startswith("seed_"):
            from ampnet_tpu_torch.models import AMPGCN

            fresh = AMPGCN(pmodel.config, generator=torch.Generator().manual_seed(pt.seed),
                           device="cpu")
            assert torch.equal(fresh.conv1.w_qkv, pmodel.conv1.w_qkv)


def graph_args(rec):
    return [(a, k) for a, k in rec.calls]


@pytest.mark.parametrize("args", [{}, {"model_name": "GCN"}, {"model_name": "TwoLayerSigmoid"},
                                  {"model_name": "LinearLayer", "seed": 3},
                                  {"duplicated_features": False, "noise_std": 0.1},
                                  {"embedding_dim": 16, "num_heads": 4}],
                         ids=lambda a: "-".join(f"{k}={v}" for k, v in a.items()) or "default")
def test_modular_xor_trainer_builds_the_jax_config(jax_side, monkeypatch, tmp_path, args):
    """The data, the registry's model options and the optimizer. The port's
    AMPNet adds use_pallas=True (its convs on the fused
    kernels); the MLPs add their input width and two outputs."""
    jm = jax_side["synthetic_training_modular"]
    recs = {}
    for side, mod in (("jax", jm), ("port", port_stm)):
        r = recs[side] = dict(model=Rec(ret=Dummy()), opt=Rec(stop_at=1),
                              dup=Rec(ret=mod.get_duplicated_xor_graphs),
                              xor=Rec(ret=mod.get_xor_graphs))
        for attr, key in (("get_model", "model"), ("make_optimizer", "opt"),
                          ("get_duplicated_xor_graphs", "dup"), ("get_xor_graphs", "xor")):
            monkeypatch.setattr(mod, attr, r[key])
    with pytest.raises(Stop):
        jm.train_model(args, run_base=str(tmp_path / "jax"))
    with pytest.raises(Stop):
        port_stm.train(args, run_base=str(tmp_path / "port"), device="cpu")
    j, p = recs["jax"], recs["port"]
    assert graph_args(p["dup"]) == graph_args(j["dup"])
    assert graph_args(p["xor"]) == graph_args(j["xor"])
    (jname,), jkw = j["model"].calls[0]
    (pname,), pkw = p["model"].calls[0]
    assert pname == jname
    extra = {k: pkw.pop(k) for k in ("generator", "device", "in_dim", "out_dim", "use_pallas")
             if k in pkw}
    assert pkw == jkw
    if pname == "AMPNet":
        assert extra["use_pallas"] is True
    elif pname != "GCN":
        n_feats = 2 * port_stm.ARGS["feature_repeats"]
        assert (extra["in_dim"], extra["out_dim"]) == (n_feats, 2)
    assert extra["generator"].initial_seed() == args.get("seed", 0)
    (jlr,), jkw = j["opt"].calls[0]
    (_, plr), pkw = p["opt"].calls[0]
    assert (plr, pkw) == (jlr, jkw)


def test_modular_xor_graphsaint_trainer_builds_the_jax_config(jax_side, monkeypatch, tmp_path):
    """Both samplers' data and options, the model, the optimizer."""
    jm = jax_side["synthetic_training_modular_graphsaint"]

    class Sampler:
        def sample(self):
            return "sub"

    recs = {}
    for side, mod in (("jax", jm), ("port", port_stmg)):
        r = recs[side] = dict(sampler=Rec(ret=Sampler()), model=Rec(ret=Dummy()),
                              opt=Rec(stop_at=1))
        monkeypatch.setattr(mod, "GraphSaintRandomWalkSampler", r["sampler"])
        monkeypatch.setattr(mod, "get_model", r["model"])
        monkeypatch.setattr(mod, "make_optimizer", r["opt"])
    with pytest.raises(Stop):
        jm.train_model({"epochs": 3, "seed": 2}, run_base=str(tmp_path / "jax"))
    with pytest.raises(Stop):
        port_stmg.train({"epochs": 3, "seed": 2},
                        run_base=str(tmp_path / "port"), device="cpu")
    j, p = recs["jax"], recs["port"]
    assert len(j["sampler"].calls) == len(p["sampler"].calls) == 2
    for (ja, jk), (pa, pk) in zip(j["sampler"].calls, p["sampler"].calls):
        for a, b in zip((*ja, *jk.values()), (*pa, *pk.values())):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert jk.keys() == pk.keys()
    pkw = dict(p["model"].calls[0][1])
    for k in ("generator", "device"):
        pkw.pop(k)
    assert pkw.pop("use_pallas") is True and pkw == j["model"].calls[0][1]
    assert j["opt"].calls[0][0][0] == p["opt"].calls[0][0][1]
    assert j["opt"].calls[0][1] == p["opt"].calls[0][1]


def test_grid_search_runs_the_jax_experiments(jax_side, monkeypatch, tmp_path):
    """The experiments' arguments and run dirs, and grid_search.csv byte for
    byte (the trainer replaced on both sides)."""
    jm = jax_side["grid_search"]
    jrec = Rec(ret=lambda args, run_base: (0.5 + args["seed"] / 10, 0.25 + args["noise_std"]))
    prec = Rec(ret=lambda args, run_base, device: {
        "max_train_acc": 0.5 + args["seed"] / 10, "max_test_acc": 0.25 + args["noise_std"],
        "history": [], "run_dir": run_base})
    monkeypatch.setattr(jm, "train_model", jrec)
    monkeypatch.setattr(port_grid, "train", prec)
    monkeypatch.setattr(port_grid, "plot_history", lambda *a: None)
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    jm.controller(noise_stds=(0.2, 0.1), repeats=2, run_base=str(tmp_path / "jax"))
    out = port_grid.controller(noise_stds=(0.2, 0.1), repeats=2, run_base=str(tmp_path / "port"),
                               device="cpu")
    assert [a[0] for a, _ in prec.calls] == [a[0] for a, _ in jrec.calls]
    assert [Path(k["run_base"]).name for _, k in prec.calls] == \
        [Path(k["run_base"]).name for _, k in jrec.calls]
    assert (tmp_path / "port" / "grid_search.csv").read_text() == \
        (tmp_path / "jax" / "grid_search.csv").read_text()
    assert (tmp_path / "port" / "grid_search_boxplot.png").exists()
    assert [w["device"] for w in out["where"]] == ["cpu"] * 4


@pytest.mark.parametrize("tokenizer", [True, False])
def test_freeze_check_builds_the_jax_model(jax_side, monkeypatch, tokenizer):
    """The model config, the data, the seed; the port trains exactly the
    head (and the tokenizer)."""
    jm = jax_side["ampnet_freeze_check"]
    recs = {}
    for side, mod in (("jax", jm), ("port", port_freeze)):
        recs[side] = dict(state=Rec(stop_at=1), data=Rec(ret=mod.get_duplicated_xor_graphs))
        monkeypatch.setattr(mod, "create_train_state", recs[side]["state"])
        monkeypatch.setattr(mod, "get_duplicated_xor_graphs", recs[side]["data"])
    with pytest.raises(Stop):
        jm.train_model(3, also_train_tokenizer=tokenizer)
    with pytest.raises(Stop):
        port_freeze.train_model(3, also_train_tokenizer=tokenizer, device="cpu")
    (jmodel, _, _), jkw = recs["jax"]["state"].calls[0]
    (pmodel, popt), pkw = recs["port"]["state"].calls[0]
    assert cfg_dict(pmodel) == cfg_dict(jmodel) and pkw == jkw
    assert graph_args(recs["port"]["data"]) == graph_args(recs["jax"]["data"])
    trainable = {n.split(".")[0] for n, p in pmodel.named_parameters() if p.requires_grad}
    assert trainable == ({"final_linear_out", "tokenizer"} if tokenizer else
                         {"final_linear_out"})
    assert len(popt.params) == sum(p.requires_grad for p in pmodel.parameters())
    assert (popt.base_lr, popt.grad_clip) == (5e-3, 1.0)


@pytest.mark.parametrize("ampconv,seed", [(True, 2), (False, 5)])
def test_mse_trainer_builds_the_jax_model(jax_side, monkeypatch, tmp_path, ampconv, seed):
    jm = jax_side["synthetic_training"]
    recs = {}
    for side, mod in (("jax", jm), ("port", port_mse)):
        recs[side] = dict(state=Rec(stop_at=1), data=Rec(ret=mod.get_xor_graphs))
        monkeypatch.setattr(mod, "create_train_state", recs[side]["state"])
        monkeypatch.setattr(mod, "get_xor_graphs", recs[side]["data"])
    with pytest.raises(Stop):
        jm.main(3, train_ampconv=ampconv, run_base=str(tmp_path / "jax"), seed=seed)
    with pytest.raises(Stop):
        port_mse.train(3, train_ampconv=ampconv, run_base=str(tmp_path / "port"), seed=seed,
                       device="cpu")
    (jmodel, _, _), jkw = recs["jax"]["state"].calls[0]
    (pmodel, popt), pkw = recs["port"]["state"].calls[0]
    jcfg, pcfg = cfg_dict(jmodel), cfg_dict(pmodel)
    if not ampconv:     # no scaler stats: the port's options say False, flax's field None
        assert jcfg.pop("scaler_stats") is None and pcfg.pop("scaler") is False
        pcfg = {k: v for k, v in pcfg.items() if k in jcfg}
    assert pcfg == jcfg and pkw == jkw == {"seed": seed}
    assert graph_args(recs["port"]["data"]) == graph_args(recs["jax"]["data"])
    assert (popt.base_lr, popt.grad_clip, popt.adam.defaults["weight_decay"]) == (0.01, None, 0.0)


def test_rgb_generator_writes_the_jax_splits(jax_side, monkeypatch, tmp_path):
    flags = ["--RGB_train", "4", "--RGB_valid", "3", "--RGB_test", "2", "--seed", "7",
             "-D", "Tiny", "--Nodes_max", "6"]
    argv(monkeypatch, "synthetic_rgb_generate.py", "-o", str(tmp_path / "jax"), *flags)
    jax_side["synthetic_rgb_generate"].main()
    paths = port_rgb.main(["-o", str(tmp_path / "port"), *flags])
    assert sorted(paths) == ["test", "train", "valid"]
    for split, path in paths.items():
        ours = pickle.loads(Path(path).read_bytes())
        theirs = pickle.loads((tmp_path / "jax" / f"Tiny_{split}.pkl").read_bytes())
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{split} {k}")


class FakeSampler:
    def sample(self):
        return self

    def to(self, device):
        return self


@pytest.mark.parametrize("name,port", [("cora_overfit_one_subgraph", port_overfit),
                                       ("cora_linear_layer_baseline", port_linear)])
def test_baselines_build_the_jax_models(jax_side, small_cora, monkeypatch, name, port):
    """The sampler's data and options, the model's fields, the optimizer."""
    jm = jax_side[name]
    recs = {}
    for side, mod in (("jax", jm), ("port", port)):
        recs[side] = dict(sampler=Rec(ret=FakeSampler()), opt=Rec(ret="tx"),
                          state=Rec(stop_at=1))
        monkeypatch.setattr(mod, "cora_graph", lambda: small_cora)
        monkeypatch.setattr(mod, "GraphSaintRandomWalkSampler", recs[side]["sampler"])
        monkeypatch.setattr(mod, "make_optimizer", recs[side]["opt"])
        monkeypatch.setattr(mod, "create_train_state", recs[side]["state"])
    with pytest.raises(Stop):
        jm.main()
    with pytest.raises(Stop):
        port.main(device="cpu")
    j, p = recs["jax"], recs["port"]
    (ja, jk), (pa, pk) = j["sampler"].calls[0], p["sampler"].calls[0]
    assert jk.keys() == pk.keys()
    for a, b in zip((*ja, *jk.values()), (*pa, *pk.values())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert j["opt"].calls[0][0] == p["opt"].calls[0][0][1:]
    assert j["opt"].calls[0][1] == p["opt"].calls[0][1]
    jmodel, pmodel = j["state"].calls[0][0][0], p["state"].calls[0][0][0]
    assert cfg_dict(pmodel) == cfg_dict(jmodel)
    assert j["state"].calls[0][1] == p["state"].calls[0][1] == {"seed": 0}
    if hasattr(jmodel, "pca_embedding"):
        np.testing.assert_allclose(pmodel.pca_embedding.numpy(),
                                   np.asarray(jmodel.pca_embedding), rtol=1e-5, atol=1e-5)


def test_lr_schedule_probe_matches_jax(jax_side, capsys):
    from ampnet_tpu.train.optim import cosine_warm_restarts

    rows = port_cosine.main()
    sched = cosine_warm_restarts(0.1, 150, 2)
    assert [i for i, _ in rows] == list(range(0, 700, 10))
    # JAX's rates are float32 (an ulp at 0.1 is 7.5e-9), the port's float64
    np.testing.assert_allclose([lr for _, lr in rows], [float(sched(i)) for i, _ in rows],
                               rtol=1e-6, atol=1e-8)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "iter     0  lr 0.100000" and len(out) == 70


def test_ensemble_accuracy_matches_jax_on_given_log_probs():
    """The argmax of the sum over members of each member's mean over its
    draws, against JAX's arithmetic (jnp.mean, sum, jnp.argmax) on the same
    arrays."""
    rng = np.random.default_rng(0)
    members = [np.log(rng.dirichlet(np.ones(7), size=(5, 40))).astype(np.float32)
               for _ in range(3)]
    y = rng.integers(0, 7, 40)
    mask = rng.random(40) < 0.6
    acc_input = None
    for draws in members:
        mean_lp = jnp.mean(jnp.asarray(draws), axis=0)
        acc_input = mean_lp if acc_input is None else acc_input + mean_lp
    pred = np.asarray(jnp.argmax(acc_input, axis=-1))
    want = float((pred[mask] == y[mask]).mean())
    assert port_ensemble.ensemble_accuracy(members, y, mask) == want
    assert port_ensemble.ensemble_accuracy(members[:1], y, mask) == float(
        (members[0].mean(0).argmax(-1)[mask] == y[mask]).mean())


# ------------------------------------------- drivers read as source (not imported)


def jax_source(name):
    return ast.parse((ROOT / "experiments" / f"{name}.py").read_text())


def argparse_defaults(tree) -> dict:
    """{flag: default} of every add_argument call (store_true: False)."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            flag = node.args[-1].value
            if "default" in kw:
                out[flag] = ast.literal_eval(kw["default"])
            elif isinstance(kw.get("action"), ast.Constant):
                out[flag] = False
    return out


def config_calls(tree, names) -> list:
    """Each AMPGCNConfig(...) call's keywords evaluated with ``names``."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "AMPGCNConfig":
            out.append({k.arg: eval(compile(ast.Expression(k.value), "<cfg>", "eval"), {}, names)
                        for k in node.keywords})
    return out


def main_defaults(tree) -> dict:
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "main":
            args = node.args.args[-len(node.args.defaults):] if node.args.defaults else []
            return {a.arg: ast.literal_eval(d) for a, d in zip(args, node.args.defaults)}
    return {}


def port_flags(module) -> dict:
    flags = argparse_defaults(ast.parse(Path(module.__file__).read_text()))
    flags.pop("--device", None)
    return flags


def test_source_read_drivers_take_the_jax_flags_and_configs():
    from ampnet_tpu_torch.core.config import AMPGCNConfig

    # partitioned_graph1_timing: the flags, the model, the graph's shape
    tree = jax_source("partitioned_graph1_timing")
    assert port_flags(port_timing) == argparse_defaults(tree)
    (cfg,) = config_calls(tree, {})
    assert dataclasses.asdict(port_timing.timing_config()) == dataclasses.asdict(
        AMPGCNConfig(**cfg))
    shape = [ast.literal_eval(n.value) for n in ast.walk(tree) if isinstance(n, ast.Assign)
             and isinstance(n.targets[0], ast.Tuple)
             and [t.id for t in n.targets[0].elts] == ["n_g", "e"]]
    assert shape == [(2712, 10556)]
    import inspect
    assert (port_timing.NODES, port_timing.EDGES) == shape[0]
    g = port_timing.problem(64, 200)
    assert g.x.shape[1] == 1433 and g.num_edges == 200

    # scaling_bench: the flags, main's defaults, the model
    tree = jax_source("scaling_bench")
    assert port_flags(port_scaling) == argparse_defaults(tree)
    jdef = main_defaults(tree)
    sig = inspect.signature(port_scaling.main)
    assert {k: sig.parameters[k].default for k in jdef} == jdef
    (cfg,) = config_calls(tree, {"f": 256})
    assert dataclasses.asdict(port_scaling.bench_config()) == dataclasses.asdict(
        AMPGCNConfig(**cfg))

    # halo_budget_run: the flags (its fixed budget is the card's memory here),
    # the model, the tokens and width
    tree = jax_source("halo_budget_run")
    assert port_flags(port_budget) == argparse_defaults(tree)
    (cfg,) = config_calls(tree, {"d": 128, "s": 20, "f": 128})
    assert dataclasses.asdict(port_budget.budget_config(128)) == dataclasses.asdict(
        AMPGCNConfig(**cfg))
    assert port_budget.kv_gb(1_048_576) == 1_048_576 * 20 * 2 * 128 * 4 / 2**30 == 20.0

    # halo_comm_accounting: the row's shape; --hlo becomes --measured
    tree = jax_source("halo_comm_accounting")
    consts = {n.targets[0].elts[0].id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Tuple)}
    assert consts == {"S": (port_halo.S, port_halo.D)}
    assert port_halo.ROW_BYTES == 20 * 2 * 128 * 4
    assert argparse_defaults(tree) == {"--hlo": False}
    assert port_flags(port_halo) == {"--measured": False, "--measured-shards": 8}


# ------------------------------------------------------------- end to end, CPU


def test_checkpoint_eval_end_to_end(small_cora, monkeypatch, tmp_path):
    """Group 1: the recipe's driver for 1 epoch writes its final
    checkpoint; eval_checkpoint (--stabilized --raw-residual gcn2 --fused)
    on the run dir reads it and gets the driver's own final metrics (the
    same params, the same draws)."""
    d, g = small_cora
    for mod in (port_full, port_eval):
        monkeypatch.setattr(mod, "cora_graph", lambda: (d, g))
    res = port_full.train(1, run_base=str(tmp_path / "runs"), raw_residual=True, device="cpu")
    out = port_eval.main([res["run_dir"], "--stabilized", "--raw-residual", "gcn2", "--fused",
                          "--device", "cpu"])
    assert Path(out["checkpoint"]).name == "checkpoint_final.pkl"
    for k, v in res["final_metrics"].items():
        assert out[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


def test_xor_family_end_to_end(tmp_path):
    """Group 2: the modular trainer on the fused op (its plain versions
    here) with checkpoints and history.csv; the GraphSAINT variant; the
    freeze check's conv1 bit for bit; the MSE trainer with its plots."""
    args = {"epochs": 21, "num_train_samples": 48, "num_test_samples": 48}
    res = port_stm.train(args, run_base=str(tmp_path / "xor"), device="cpu")
    run = Path(res["run_dir"])
    assert sorted(p.name for p in run.glob("checkpoint_ep*.pkl")) == \
        ["checkpoint_ep0.pkl", "checkpoint_ep20.pkl"]
    assert (run / "history.csv").exists() and 0.0 <= res["max_test_acc"] <= 1.0
    assert res["history"][-1]["loss"] < res["history"][0]["loss"]
    res = port_stmg.train({"epochs": 2, "num_train_samples": 48, "num_test_samples": 48},
                          run_base=str(tmp_path / "saint"), device="cpu")
    assert len(res["history"]) == 2 and np.isfinite(res["history"][-1]["loss"])
    res = port_freeze.train_model(3, device="cpu")
    assert res["conv1_max_delta"] == 0.0 and res["state"].step == 3
    out = port_mse.main(2, run_base=str(tmp_path / "mse"), viz_every=4, device="cpu")
    assert set(out) == {"final_test_acc", "max_test_acc", "max_train_acc"}
    run = next((tmp_path / "mse").iterdir())
    for name in ("history.csv", "loss_curves.png", "acc_curves.png"):
        assert (run / name).exists(), name
    assert any((run / "gradients").rglob("*.png")) and any((run / "activations").glob("*.png"))


def test_baselines_end_to_end(small_cora, monkeypatch):
    """Group 3: the overfit harness's loss falls on one subgraph; the linear
    baseline takes a step on a subgraph and evaluates the full graph."""
    for mod in (port_overfit, port_linear):
        monkeypatch.setattr(mod, "cora_graph", lambda: small_cora)
    res = port_overfit.main(5, device="cpu")
    assert res["losses"][-1] < res["losses"][0] and res["nodes"] > 0
    res = port_linear.main(1, 1, device="cpu")
    assert 0.0 <= res["test_acc"] <= 1.0 and np.isfinite(res["epoch_losses"]).all()
