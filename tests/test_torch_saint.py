"""The port's GraphSAINT slice against the JAX package: the sampler
(array-equal subgraphs for one seed, both on the numpy core; the native
core's parity is tests/test_torch_native.py's), the
node_norm-weighted losses, one whole ``make_pallas_train_step`` step on a
layout without a sender side (JAX: Pallas in interpret mode), and
``train_saint`` on a tiny problem on the CPU.

Both models get the same parameters (converted from the flax tree), the
same subgraph arrays and the same injected ``sampled_idx``, with dropout
rates 0: the two frameworks' random streams differ.

Tolerances: losses 1e-6; the whole step's loss rtol 1e-5 and its parameters
atol 1e-5 wherever |g + wd*p| > 1e-5 (Adam's first update is
lr * g / (|g| + eps): where g is rounding noise around eps the update is
noise on both sides, and only its bound, lr, is held)."""
import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
from ampnet_tpu.data.graphsaint import GraphSaintRandomWalkSampler as JaxSampler
from ampnet_tpu.data.graphsaint import random_walk as jax_random_walk
from ampnet_tpu.models import AMPGCN as JaxAMPGCN
from ampnet_tpu.ops.pallas import edge_attention_fused as jeaf
from ampnet_tpu.train import create_train_state as jax_create_train_state
from ampnet_tpu.train import losses as jlosses
from ampnet_tpu.train import pallas_step as jstep
from ampnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig, TrainConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler, random_walk
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train import (
    create_train_state,
    load_checkpoint_params,
    losses,
    make_optimizer,
    make_train_step,
    pallas_step,
    train_saint,
)
from ampnet_tpu_torch.train import loop as tloop
from ampnet_tpu_torch.train.checkpoint import _read_payload
from ampnet_tpu_torch.train.rundir import Logfile

F, S, TN = 24, 5, 8
CFG = dict(embedding_dim=16, num_heads=2, num_node_features=F,
           num_sampled_vectors=S, output_dim=3, feat_emb_dim=15, val_emb_dim=1,
           token_sampling="tfidf", scaler="precomputed", raw_residual="gcn2",
           dropout_rate=0.0, dropout_adj_rate=0.0, use_pallas=True)
RECIPE = dict(learning_rate=3e-3, weight_decay=5e-4, grad_clip=1.0)


def base_graph(seed=0, n=60, e=300):
    """Three classes, each with its own block of 8 likely features."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x = (rng.random((n, F)) < 0.1).astype(np.float32)
    for c in range(3):
        x[y == c, 8 * c: 8 * c + 8] = rng.random((int((y == c).sum()), 8)) < 0.6
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    split = rng.random(n)
    return dict(x=x, edge_index=ei, y=y, train_mask=split < 0.5,
                val_mask=(split >= 0.5) & (split < 0.75), test_mask=split >= 0.75)


SAMPLER = dict(batch_size=3, walk_length=4, num_steps=5, sample_coverage=5)


def assert_graphs_equal(gt, gj):
    for f in dataclasses.fields(gt):
        a, b = getattr(gt, f.name), getattr(gj, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)


# ------------------------------------------------------------------ sampler


def test_random_walk_matches_jax_and_stays_put_without_edges():
    base = base_graph()
    ours = GraphSaintRandomWalkSampler(**base, **SAMPLER, seed=1)
    starts = np.arange(7)
    a = random_walk(ours.indptr, ours.indices, starts, 6, np.random.default_rng(3))
    b = jax_random_walk(ours.indptr, ours.indices, starts, 6, np.random.default_rng(3))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (7, 7) and (a[:, 0] == starts).all()
    still = random_walk(np.zeros(8, np.int64), np.zeros(0, np.int32), starts, 3,
                        np.random.default_rng(0))
    assert (still == starts[:, None]).all()


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("seed,coverage", [(1, 5), (4, 0)])
def test_sampler_yields_the_jax_samplers_subgraphs(seed, coverage, native):
    """Same seed and core -> array-equal norms, pad sizes and padded
    subgraphs, over two epochs."""
    base = base_graph()
    kw = {**SAMPLER, "sample_coverage": coverage}
    ours = GraphSaintRandomWalkSampler(**base, **kw, seed=seed, use_native=native)
    theirs = JaxSampler(**base, **kw, seed=seed, use_native=native)
    np.testing.assert_array_equal(ours.node_norm, theirs.node_norm)
    np.testing.assert_array_equal(ours.edge_norm, theirs.edge_norm)
    assert (ours.pad_nodes_to, ours.pad_edges_to) == (theirs.pad_nodes_to, theirs.pad_edges_to)
    assert len(ours) == len(theirs) == 5
    sizes = set()
    for _ in range(2):
        for gt, gj in zip(ours, theirs):
            assert_graphs_equal(gt, gj)
            assert gt.num_nodes_padded == ours.pad_nodes_to
            assert gt.x.dtype == torch.float32 and gt.senders.dtype == torch.int64
            sizes.add((gt.num_nodes, gt.num_edges))
    assert len(sizes) > 3                                  # subgraphs differ
    if coverage:
        assert ours.node_norm.std() > 0 and ours.edge_norm.max() <= 1e4
    else:
        assert (ours.node_norm == 1).all() and (ours.edge_norm == 1).all()


def test_prefetch_yields_the_sequence_of_iter():
    base = base_graph()
    a = GraphSaintRandomWalkSampler(**base, **SAMPLER, seed=2)
    b = GraphSaintRandomWalkSampler(**base, **SAMPLER, seed=2)
    for _ in range(2):                                     # the thread ends with its epoch
        got, want = list(a.prefetch(depth=2)), list(b)
        assert len(got) == len(want) == 5
        for x, y in zip(got, want):
            assert_graphs_equal(x, y)
    # an abandoned consumer releases the producer; the next epoch goes on
    it = a.prefetch(depth=1)
    next(it)
    it.close()
    assert len(list(a.prefetch())) == 5


def test_pad_regrow_matches_jax():
    base = base_graph()
    kw = dict(**SAMPLER, pad_nodes_to=8, pad_edges_to=128, seed=3)
    ours = GraphSaintRandomWalkSampler(**base, **kw, use_native=False)
    theirs = JaxSampler(**base, **kw, use_native=False)
    with pytest.warns(UserWarning, match="exceeds pad budget"):
        gt = ours.sample()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gj = theirs.sample()
    assert ours.pad_nodes_to > 8 and ours.pad_nodes_to % 64 == 0
    assert (ours.pad_nodes_to, ours.pad_edges_to) == (theirs.pad_nodes_to, theirs.pad_edges_to)
    assert_graphs_equal(gt, gj)


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("name", ["saint_weighted_nll", "saint_weighted_mean_nll"])
def test_saint_losses_match_jax(rng, name):
    logp = np.log(rng.dirichlet(np.ones(4), size=30)).astype(np.float32)
    y = rng.integers(0, 4, 30)
    norm = rng.random(30).astype(np.float32) * 0.01
    mask = rng.random(30) < 0.5
    got = getattr(losses, name)(torch.from_numpy(logp), torch.from_numpy(y),
                                torch.from_numpy(norm), torch.from_numpy(mask))
    ref = getattr(jlosses, name)(jnp.asarray(logp), jnp.asarray(y), jnp.asarray(norm),
                                 jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-6)
    none = getattr(losses, name)(torch.from_numpy(logp), torch.from_numpy(y),
                                 torch.from_numpy(norm), torch.zeros(30, dtype=torch.bool))
    assert float(none) == 0.0                              # an empty mask is no NaN


# ------------------------------------------------------------------ the step


def both_models(sub_j):
    base = base_graph()
    stats = fit_scaler(base["x"])
    jm = JaxAMPGCN(config=JaxConfig(**CFG), scaler_stats=stats)
    k = jax.random.PRNGKey(0)
    params = jm.init({"params": k, "sample": k, "dropout": k, "edges": k}, sub_j,
                     return_aux=False)["params"]
    tm = AMPGCN(AMPGCNConfig(**CFG), scaler_stats=stats, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    return jm, params, tm


class InjectedDraw:
    """A JAX model whose every apply uses one fixed token draw (the step
    itself cannot be handed one)."""

    def __init__(self, model, idx):
        self.model, self.config, self.idx = model, model.config, idx

    def apply(self, variables, graph, **kw):
        return self.model.apply(variables, graph, sampled_idx=self.idx, **kw)


@pytest.mark.parametrize("loss_mode", ["saint_mean", "saint"])
def test_pallas_train_step_matches_jax(rng, monkeypatch, loss_mode):
    """One make_pallas_train_step step on a sampled subgraph with
    compute_layout(sender_layout=False): forward K1, backward K5 + pass B
    (their plain versions here) against the JAX step, whose backward is the
    stream backward too (no snd_*), in interpret mode."""
    monkeypatch.setattr(jeaf, "_auto_group", lambda sp, emax, gather: 8)
    base = base_graph()
    gt = next(iter(GraphSaintRandomWalkSampler(**base, **SAMPLER, seed=1, use_native=False)))
    gj = next(iter(JaxSampler(**base, **SAMPLER, seed=1, use_native=False)))
    lt = pallas_step.compute_layout(gt, tile_nodes=TN, edges_per_tile=128,
                                    sender_layout=False)
    lj = jstep.compute_layout(gj, tile_nodes=TN, edges_per_tile=128, sender_layout=False)
    assert lt.snd_ptr is None and lj.snd_receivers is None
    jm, params, tm = both_models(gj)
    idx = rng.integers(0, F, (gt.num_nodes_padded, S))

    jstate = jax_create_train_state(jm, gj, jax_make_optimizer(**RECIPE), seed=0)
    jstate = jstate.replace(params=params)
    jnew, jmetrics = jstep.make_pallas_train_step(
        InjectedDraw(jm, jnp.asarray(idx)), loss_mode=loss_mode, interpret=True)(
            jstate, gj, lj)

    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    state = create_train_state(tm, make_optimizer(tm.parameters(), **RECIPE), seed=0)
    forward = tm.forward
    tm.forward = lambda g, **kw: forward(g, **{**kw, "sampled_idx": torch.from_numpy(idx)})
    ran = []
    for mod, name in ((sb, "edge_attention_bwd_stream"), (bwd, "edge_attention_bwd_dq")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k: (
            ran.append(_n), _o(*a, **k))[1])
    state, metrics = pallas_step.make_pallas_train_step(tm, loss_mode=loss_mode)(
        state, gt, lt)
    assert ran == ["edge_attention_bwd_stream"] * 2 and state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["train_acc"]), float(jmetrics["train_acc"]))

    checked = 0
    named = dict(tm.named_parameters())
    for k, v in flax_to_state_dict(jax.device_get(jnew.params)).items():
        got = named[k].detach()
        # the clipped gradient is still in .grad; decayed as Adam saw it
        firm = (named[k].grad + RECIPE["weight_decay"] * before[k]).abs() > 1e-5
        checked += int(firm.sum())
        np.testing.assert_allclose(got[firm].numpy(), v[firm].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
        assert float((got - before[k]).abs().max()) <= RECIPE["learning_rate"] * 1.001, k
    total = sum(v.numel() for v in before.values())
    # the weighted SUM is ~1e-2, so fewer of its gradients stand clear of eps
    assert checked > (0.5 if loss_mode == "saint_mean" else 0.05) * total


def test_train_step_loss_modes(rng):
    """make_train_step's three losses on one graph and draw; an unknown
    mode raises; fused_fns refuse edge dropout as the JAX model does."""
    base = base_graph()
    gt = next(iter(GraphSaintRandomWalkSampler(**base, **SAMPLER, seed=1)))
    tm = AMPGCN(AMPGCNConfig(**CFG), scaler_stats=fit_scaler(base["x"]), device="cpu")
    idx = torch.from_numpy(rng.integers(0, F, (gt.num_nodes_padded, S)))
    with torch.no_grad():
        logits = tm(gt, sampled_idx=idx)
    train = gt.train_mask & gt.node_mask
    want = {"full": losses.masked_mean_nll(logits, gt.y, train),
            "saint": losses.saint_weighted_nll(logits, gt.y, gt.node_norm, train),
            "saint_mean": losses.saint_weighted_mean_nll(logits, gt.y, gt.node_norm, train)}
    assert len({round(float(v), 6) for v in want.values()}) == 3
    forward = tm.forward
    tm.forward = lambda g, **kw: forward(g, **{**kw, "sampled_idx": idx})
    for mode, loss in want.items():
        state = create_train_state(tm, make_optimizer(tm.parameters(), 0.0), seed=0)
        _, metrics = make_train_step(tm, loss_mode=mode)(state, gt)
        np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown loss_mode"):
        make_train_step(tm, loss_mode="mean")
    tm.forward = forward
    tm.config = dataclasses.replace(tm.config, dropout_adj_rate=0.2)
    lt = pallas_step.compute_layout(gt, tile_nodes=TN)
    with pytest.raises(ValueError, match="dropout_adj_rate > 0 on the fused path"):
        tm(gt, deterministic=False, generator=torch.Generator().manual_seed(0),
           fused_fns=pallas_step.make_fused_fns(tm, gt, lt))


def test_make_fused_fns_follow_the_layout(rng):
    """tile_nodes comes from the layout; the closures give the layout path's
    logits and gradients, with and without a sender side, and with
    fused_bwd=False; D need not be a multiple of 128."""
    base = base_graph()
    gt = next(iter(GraphSaintRandomWalkSampler(**base, **SAMPLER, seed=1)))
    tm = AMPGCN(AMPGCNConfig(**CFG), scaler_stats=fit_scaler(base["x"]), device="cpu")
    idx = torch.from_numpy(rng.integers(0, F, (gt.num_nodes_padded, S)))
    full = pallas_step.compute_layout(gt, tile_nodes=TN)
    assert pallas_step.EdgeLayout is type(full)
    assert pallas_step.default_edge_budget(10624, 43) % 128 == 0

    def run(**kw):
        tm.zero_grad(set_to_none=True)
        logits = tm(gt, deterministic=False, sampled_idx=idx, **kw)
        losses.saint_weighted_mean_nll(logits, gt.y, gt.node_norm,
                                       gt.train_mask & gt.node_mask).backward()
        return logits.detach(), {k: p.grad.clone() for k, p in tm.named_parameters()}

    want, want_grads = run(edge_layout=full)
    for layout, fused_bwd in ((full, True), (full, False),
                              (pallas_step.compute_layout(gt, tile_nodes=TN,
                                                          sender_layout=False), True)):
        got, grads = run(fused_fns=pallas_step.make_fused_fns(tm, gt, layout,
                                                              fused_bwd=fused_bwd))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for k, g in want_grads.items():
            torch.testing.assert_close(grads[k], g, rtol=2e-4,
                                       atol=2e-6 * max(1.0, float(g.abs().max())), msg=k)
    with pytest.raises(ValueError, match="inconsistent with layout"):
        run(fused_fns=pallas_step.make_fused_fns(tm, gt, full, tile_nodes=16))


# ------------------------------------------------------------------ the loop


LOOP = dict(learning_rate=1e-2, weight_decay=5e-4, grad_clip=1.0, cosine_t_mult=1,
            select_best_every=1, num_eval_samples=2, saint_loss="mean", seed=0,
            checkpoint_every=2, log_every_steps=2)


def saint_problem():
    """48 nodes, 380 edges; walks that cover nearly the whole graph, so that
    every subgraph has more than 256 edges in its one tile."""
    base = base_graph(seed=1, n=48, e=380)
    full = from_arrays(base["x"], base["edge_index"], y=base["y"],
                       train_mask=base["train_mask"], val_mask=base["val_mask"],
                       test_mask=base["test_mask"])
    cfg = AMPGCNConfig(**{**CFG, "dropout_rate": 0.3})

    def make():
        return (AMPGCN(cfg, scaler_stats=fit_scaler(base["x"]), device="cpu"),
                GraphSaintRandomWalkSampler(**base, batch_size=20, walk_length=20,
                                            num_steps=6, sample_coverage=20, seed=1))
    return full, make


def capture():
    lines = []
    log = Logfile()
    log.log = lines.append
    return log, lines


def test_train_saint_regrows_selects_checkpoints_and_resumes(tmp_path, monkeypatch):
    full, make = saint_problem()
    # a budget of 128 slots per tile: the first subgraph overflows it
    monkeypatch.setattr(tloop, "_saint_layout_budget", lambda sampler, tile_nodes=256: 128)
    cfg = TrainConfig(**LOOP, epochs=4, cosine_t0=6 * 6, run_dir=str(tmp_path))
    model, sampler = make()
    log, lines = capture()
    result = train_saint(model, sampler, full, cfg, log=log)
    regrown = [l for l in lines if "budget regrown" in l]
    assert regrown == ["edge-layout budget regrown to 384"]      # once, for all steps
    hist = result["history"]
    assert [r["epoch"] for r in hist] == [0, 1, 2, 3] and result["state"].step == 24
    assert set(hist[0]) == {"loss", "train_acc", "test_acc", "epoch", "lr"}
    # the last step's row of each epoch; the schedule advances per step
    lrs = [float(l.split("LR: ")[1].split(",")[0]) for l in lines if "Partition:" in l]
    assert len(lrs) == 4 * 4 and lrs[0] == pytest.approx(1e-2)  # partitions 0, 2, 4, 5
    assert all(a > b for a, b in zip(lrs, lrs[1:]))
    assert lines[0].startswith("edge-layout") and "Epoch: 000, Partition: 000, LR: 0.010000" in lines[1]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert sum("Eval epoch" in l for l in lines) == 4
    assert sorted(os.listdir(tmp_path)) == [
        "checkpoint_best.pkl", "checkpoint_ep1.pkl", "checkpoint_ep3.pkl",
        "checkpoint_final.pkl"]
    best = _read_payload(str(tmp_path / "checkpoint_best.pkl"))
    assert best["epoch"] in range(4) and 0.0 <= best["extra"]["best_val_acc"] <= 1.0
    banked = load_checkpoint_params(str(tmp_path / "checkpoint_best.pkl"))
    for k, v in result["final_params"].items():
        assert torch.equal(v, banked[k]), k
    assert set(result["final_metrics"]) == {
        f"{s}_{m}" for s in ("train", "val", "test") for m in ("acc", "loss")}

    # a second call resumes after the last epoch and keeps the banked best
    model2, sampler2 = make()
    log2, lines2 = capture()
    resumed = train_saint(model2, sampler2, full, dataclasses.replace(cfg, epochs=6),
                          log=log2, prefetch=False)
    assert lines2[0] == "resumed from epoch 3" and "restored banked best" in lines2[1]
    assert [r["epoch"] for r in resumed["history"]] == [4, 5]
    assert resumed["state"].step == 36
    after = _read_payload(str(tmp_path / "checkpoint_best.pkl"))
    assert after["extra"]["best_val_acc"] >= best["extra"]["best_val_acc"]


def test_train_saint_plain_path_and_unported_option(tmp_path):
    """use_pallas off builds no layout; the sum loss is the default;
    profile_steps (the one option that raised before it was ported) trains
    and writes its trace."""
    full, make = saint_problem()
    model, sampler = make()
    for conv in (model.conv1, model.conv2):
        conv.use_pallas = False
    model.config = dataclasses.replace(model.config, use_pallas=False)
    cfg = TrainConfig(learning_rate=1e-2, weight_decay=0.0, epochs=1, cosine_t0=None,
                      checkpoint_every=0, seed=0)
    log, lines = capture()
    result = train_saint(model, sampler, full, cfg, log=log, prefetch=False)
    assert len(result["history"]) == 1 and np.isfinite(result["history"][0]["loss"])
    assert not any("budget" in l for l in lines)
    result = train_saint(model, sampler, full, dataclasses.replace(
        cfg, profile_steps=1, run_dir=str(tmp_path)), log=log, prefetch=False)
    assert len(result["history"]) == 1
    assert (tmp_path / "profile" / "trace.json").is_file()
