"""The port's step builders on the CPU, where they run their eager bodies
(on the card they capture them as CUDA graphs: tests/test_torch_cuda.py):
``make_scan_train_step`` against k steps of the port's own and against the
JAX package's ``make_scan_train_step``, the k-step graph's learning-rate
table against torch's schedule, and the fixed-capacity layouts that let one
captured step replay on every GraphSAINT subgraph.

Tolerances: the port against itself exactly (same generator, same order of
operations); against JAX the whole-step test's (``test_torch_train.py``):
losses rtol 1e-5, parameters atol 1e-5 wherever |g + wd*p| > 1e-5 in the
first step (Adam's update is lr * m / (sqrt(v) + eps): where the gradient
is rounding noise around eps, the update is noise on both sides and only
its bound, about lr a step on each side, is held); padded layouts against exact ones exactly
(the padding is never walked, and pass B adds +0.0 for it)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
from ampnet_tpu.models import AMPGCN as JaxAMPGCN
from ampnet_tpu.ops.tokenize import tfidf_sample_features as jax_tfidf
from ampnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ampnet_tpu.train.state import create_train_state as jax_create_train_state
from ampnet_tpu.train.state import make_scan_train_step as jax_make_scan_train_step
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig, TrainConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
from ampnet_tpu_torch.ops.hopper.format import compute_layout
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.ops.tokenize import tfidf_sample_features
from ampnet_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_scan_train_step,
    make_train_step,
    train_saint,
)
from ampnet_tpu_torch.train import loop as tloop
from ampnet_tpu_torch.train.rundir import Logfile

F, S, N = 24, 4, 16
CFG = dict(embedding_dim=16, num_heads=2, num_node_features=F,
           num_sampled_vectors=S, output_dim=3, feat_emb_dim=15, val_emb_dim=1,
           token_sampling="tfidf", scaler="precomputed", raw_residual="gcn2",
           dropout_rate=0.0, dropout_adj_rate=0.0)
RECIPE = dict(learning_rate=3e-3, weight_decay=1e-3, grad_clip=1.0)
K = 3


def one_feature_graphs(rng):
    """N nodes, none of them padding, each with exactly ONE present
    feature: every token draw of either package is that feature."""
    x = np.zeros((N, F), np.float32)
    x[np.arange(N), rng.integers(0, F, N)] = 1.0
    ei = np.stack([rng.integers(0, N, 48), rng.integers(0, N, 48)])
    split = rng.random(N)
    kw = dict(y=rng.integers(0, 3, N), train_mask=split < 0.5,
              val_mask=(split >= 0.5) & (split < 0.75), test_mask=split >= 0.75,
              pad_nodes_to=N, pad_edges_to=64)
    return x, jax_from_arrays(x, ei, **kw), from_arrays(x, ei, **kw)


def noisy_problem(seed=0, n=40, e=160):
    """A graph whose training step draws tokens, dropout and edge dropout."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, F)) < 0.3).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    split = rng.random(n)
    g = from_arrays(x, ei, y=rng.integers(0, 3, n), train_mask=split < 0.6,
                    test_mask=split >= 0.6, pad_nodes_to=48, pad_edges_to=192)
    cfg = AMPGCNConfig(**{**CFG, "dropout_rate": 0.3, "dropout_adj_rate": 0.1,
                          "use_pallas": True})
    return g, lambda: AMPGCN(cfg, scaler_stats=fit_scaler(x), device="cpu",
                             generator=torch.Generator().manual_seed(3))


# ------------------------------------------------------------------ scan step


@pytest.mark.parametrize("cosine_t0", [None, 2])
def test_scan_train_step_equals_k_train_steps(cosine_t0):
    """K steps in one make_scan_train_step call equal K make_train_step
    calls bit for bit: parameters, Adam's state, the generator, the
    optimizer's count and each step's metrics (stacked [K])."""
    g, make = noisy_problem()
    layout = compute_layout(g, tile_nodes=16)
    runs = []
    for scan in (False, True):
        model = make()
        state = create_train_state(model, make_optimizer(
            model.parameters(), **RECIPE, cosine_t0=cosine_t0, cosine_t_mult=1), seed=5)
        if scan:
            state, metrics = make_scan_train_step(model, num_steps=K)(state, g, layout)
        else:
            step, rows = make_train_step(model), []
            for _ in range(K):
                state, m = step(state, g, layout)
                rows.append(m)
            metrics = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        runs.append((state, metrics))
    (a, ma), (b, mb) = runs
    assert set(ma) == {"loss", "train_acc", "test_acc"} and ma["loss"].shape == (K,)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert len(set(ma["loss"].tolist())) == K          # three different steps
    assert a.step == b.step == K and a.optimizer.count == b.optimizer.count == K
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
    for p, q in zip(a.optimizer.params, b.optimizer.params):
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.adam.state[p][name],
                               b.optimizer.adam.state[q][name]), name


def test_one_present_feature_forces_both_samplers(rng):
    """The premise of the JAX comparison: with one present feature per node
    both packages' TF-IDF samplers return it, whatever their draws."""
    x, gj, gt = one_feature_graphs(rng)
    want = np.argmax(x, axis=1)[:, None].repeat(8, axis=1)
    for seed in range(3):
        got_j = np.asarray(jax_tfidf(jax.random.PRNGKey(seed), jnp.asarray(x), 8,
                                     node_mask=gj.node_mask))
        got_t = tfidf_sample_features(gt.x, 8, node_mask=gt.node_mask,
                                      generator=torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(got_j, want)
        np.testing.assert_array_equal(got_t.numpy(), want)


def test_scan_train_step_matches_jax_scan(rng):
    """The port's make_scan_train_step(K) against the JAX package's on the
    same parameters (converted from the flax tree), dropout and edge
    dropout 0, and token draws forced by one present feature per node:
    the stacked losses and accuracies, and the parameters after K steps."""
    x, gj, gt = one_feature_graphs(rng)
    stats = fit_scaler(x)
    jm = JaxAMPGCN(config=JaxConfig(**CFG), scaler_stats=stats)
    jstate = jax_create_train_state(jm, gj, jax_make_optimizer(**RECIPE), seed=0)
    params = jstate.params
    tm = AMPGCN(AMPGCNConfig(**CFG), scaler_stats=stats, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    loss0, grads0 = _first_grads(jm, params, gj)
    decayed = flax_to_state_dict(jax.device_get(jax.tree_util.tree_map(
        lambda g, p: g + RECIPE["weight_decay"] * p, grads0, params)))

    # the JAX step donates its state (params included)
    jnew, jmetrics = jax_make_scan_train_step(jm, num_steps=K)(jstate, gj)
    state = create_train_state(tm, make_optimizer(tm.parameters(), **RECIPE), seed=0)
    state, metrics = make_scan_train_step(tm, num_steps=K)(state, gt)

    assert metrics["loss"].shape == (K,) and state.step == K
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jmetrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"][0]), loss0, rtol=1e-5)
    for name in ("train_acc", "test_acc"):
        np.testing.assert_allclose(metrics[name].numpy(), np.asarray(jmetrics[name]))
    checked = 0
    for k, v in flax_to_state_dict(jax.device_get(jnew.params)).items():
        got = dict(tm.named_parameters())[k].detach()
        firm = decayed[k].abs() > 1e-5
        checked += int(firm.sum())
        np.testing.assert_allclose(got[firm].numpy(), v[firm].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
        # elsewhere both updates are noise of at most ~lr a step each
        assert float((got - v).abs().max()) <= 2.1 * K * RECIPE["learning_rate"], k
    assert checked > 0.5 * sum(v.numel() for v in before.values())


def _first_grads(jm, params, gj):
    from ampnet_tpu.train.losses import masked_mean_nll as jax_nll

    def loss_fn(p):
        k = jax.random.PRNGKey(1)
        out = jm.apply({"params": p}, gj, deterministic=False, return_aux=False,
                       rngs={"sample": k, "dropout": k, "edges": k})
        return jax_nll(out.logits, gj.y, gj.train_mask & gj.node_mask)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), grads


@pytest.mark.parametrize("t_0,t_mult,eta_min", [(5, 1, 0.0), (4, 2, 1e-4), (3, 3, 0.0)])
def test_rate_table_equals_the_schedule(t_0, t_mult, eta_min):
    """The rates a k-step graph's table is filled with (Optimizer.rates)
    equal torch's CosineAnnealingWarmRestarts rate for rate, at any count."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = make_optimizer([p], learning_rate=0.1, cosine_t0=t_0, cosine_t_mult=t_mult,
                         eta_min=eta_min)
    shadow = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1)
    sched = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(
        shadow, T_0=t_0, T_mult=t_mult, eta_min=eta_min)
    want = []
    for _ in range(60):
        want.append(shadow.param_groups[0]["lr"])
        shadow.step()
        sched.step()
    for start in (0, 7, 23):
        while opt.count < start:
            p.grad = torch.ones(3)
            opt.step()
        assert opt.rates(10) == want[start: start + 10]
        assert opt.learning_rate == want[start]
    constant = make_optimizer([p], learning_rate=0.1)
    assert constant.rates(4) == [0.1] * 4


# ------------------------------------------------------------------ fixed capacity


def _live_prefix(lay):
    """The same layout with its slots cut to the live ones (the exact
    layout a budget's padding is held against)."""
    return dataclasses.replace(lay, recv_slots=lay.recv_slots[: int(lay.recv_ptr[-1])],
                               snd_slots=lay.snd_slots[: int(lay.snd_ptr[-1])])


def test_fixed_capacity_layout_pads_to_the_budget():
    """A layout of a fixed budget pads its slots to capacity with slot 0;
    the live prefix is the unbudgeted layout's index, and one without a
    budget is not padded."""
    g, _ = noisy_problem()
    fixed = compute_layout(g, tile_nodes=16, edges_per_tile=128)
    free = compute_layout(g, tile_nodes=16)
    t, emax = fixed.tile_senders.shape
    live = int(fixed.recv_ptr[-1])
    assert fixed.recv_slots.shape == (t * emax,) and free.recv_slots.shape == (live,)
    assert not fixed.recv_slots[live:].any()
    assert fixed.snd_slots.shape == (fixed.snd_receivers.numel(),)
    assert free.snd_slots.shape == (int(free.snd_ptr[-1]),)
    assert not fixed.snd_slots[int(fixed.snd_ptr[-1]):].any()
    # the same edges in the same receiver (sender) order, slot ids of the budget
    tile_of = _live_prefix(fixed).recv_slots.long() // emax
    free_tile_of = free.recv_slots.long() // free.tile_senders.shape[1]
    assert torch.equal(tile_of, free_tile_of)
    for f in ("recv_ptr", "snd_ptr", "edge_slot"):
        assert torch.equal(getattr(fixed, f) >= 0, getattr(free, f) >= 0), f
    assert torch.equal(fixed.recv_ptr, free.recv_ptr)
    assert torch.equal(fixed.snd_ptr, free.snd_ptr)


def _kernel_inputs(seed=0, d=16, h=2, s=5):
    g, _ = noisy_problem(seed)
    gen = torch.Generator().manual_seed(seed)
    sp = 8
    nt = 48
    q = torch.randn(nt * sp, d, generator=gen)
    kv = torch.randn(nt * sp, 2 * d, generator=gen)
    dsum = torch.randn(nt * sp, d, generator=gen)
    kw = dict(s=s, sp=sp, num_heads=h, softmax=True)
    return g, q, kv, dsum, kw


def test_plain_versions_and_pass_b_ignore_the_padding():
    """K1's, K3's, K4's and K5's plain versions and pass B give the same
    results, bit for bit, over a fixed-capacity layout as over the exact
    one, the stream's rows of the padding (never written on the card)
    holding NaN; the chunked fold of the stream backward too."""
    g, q, kv, dsum, kw = _kernel_inputs()
    fixed = compute_layout(g, tile_nodes=16, edges_per_tile=128)
    exact = _live_prefix(fixed)

    def walks(lay):
        return ((lay.tile_senders, lay.tile_valid, lay.recv_ptr, lay.recv_slots),
                (lay.snd_receivers, lay.snd_valid, lay.snd_ptr, lay.snd_slots))

    (r_e, s_e), (r_f, s_f) = walks(exact), walks(fixed)
    assert torch.equal(eaf.edge_attention_sums(q, kv, *r_f, **kw),
                       eaf.edge_attention_sums(q, kv, *r_e, **kw))
    assert torch.equal(bwd.edge_attention_bwd_dq(q, kv, dsum, *r_f, **kw),
                       bwd.edge_attention_bwd_dq(q, kv, dsum, *r_e, **kw))
    qdm = torch.cat([q, dsum], dim=1)
    assert torch.equal(bwd.edge_attention_bwd_dkv(qdm, kv, *s_f, **kw),
                       bwd.edge_attention_bwd_dkv(qdm, kv, *s_e, **kw))
    dq_e, stream_e = sb.edge_attention_bwd_stream(q, kv, dsum, *r_e, **kw)
    dq_f, stream_f = sb.edge_attention_bwd_stream(q, kv, dsum, *r_f, **kw)
    assert torch.equal(dq_f, dq_e) and torch.equal(stream_f, stream_e)

    # pass B: the rows pass A never wrote hold NaN; the walked slots are
    # picked on the device, from recv_ptr alone
    emax = exact.tile_senders.shape[1]
    walked = torch.zeros(stream_e.shape[0] // kw["sp"], dtype=torch.bool)
    walked[exact.recv_slots.long()] = True
    tiles = (0, exact.tile_senders.shape[0])
    for lay in (exact, fixed):
        assert torch.equal(sb.walked_slots(lay.tile_senders, lay.recv_ptr, tiles), walked)
        assert torch.equal(sb.walked_slots(lay.tile_senders, lay.recv_ptr, (1, 3)),
                           walked[emax: 3 * emax])
    nan_stream = stream_e.view(-1, kw["sp"], stream_e.shape[1]).clone()
    nan_stream[~walked] = float("nan")
    nan_stream = nan_stream.view_as(stream_e)
    acc = torch.zeros(48, kw["s"], 2 * q.shape[1])
    got = sb.stream_to_senders(nan_stream, fixed.tile_senders, walked, 0, acc,
                               s=kw["s"], sp=kw["sp"])
    # the walked rows alone, in slot order: the same sums, bit for bit
    ids = torch.nonzero(walked)[:, 0]
    want = torch.zeros_like(acc).index_add_(
        0, fixed.tile_senders.reshape(-1)[ids].long(),
        nan_stream.view(-1, kw["sp"], stream_e.shape[1])[ids, : kw["s"]])
    assert torch.isfinite(got).all() and torch.equal(got, want)

    for budget in (None, 6 * emax * kw["sp"] * 2 * q.shape[1] * 4):   # 1 and 3 chunks
        a = sb.stream_backward(q, kv, dsum, *r_e, **kw, chunk_bytes=budget)
        b = sb.stream_backward(q, kv, dsum, *r_f, **kw, chunk_bytes=budget)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("chunk_tiles", [1, 2])
def test_pass_b_works_on_one_chunk_at_a_time(monkeypatch, chunk_tiles):
    """The stream backward's live memory and pass B's work stay those of one
    chunk of tiles: each pass B gets that chunk's stream and a mask of its
    slots alone, never the whole graph's slots."""
    g, q, kv, dsum, kw = _kernel_inputs()
    lay = compute_layout(g, tile_nodes=16, edges_per_tile=128)
    t, emax = lay.tile_senders.shape
    seen = []
    real = sb.stream_to_senders

    def record(stream, tile_senders, take, slot0, out, **k):
        seen.append((stream.shape[0] // kw["sp"], take.numel(), slot0))
        return real(stream, tile_senders, take, slot0, out, **k)

    monkeypatch.setattr(sb, "stream_to_senders", record)
    budget = chunk_tiles * emax * kw["sp"] * 2 * q.shape[1] * 4
    idx = (lay.tile_senders, lay.tile_valid, lay.recv_ptr, lay.recv_slots)
    dq, dkv = sb.stream_backward(q, kv, dsum, *idx, **kw, chunk_bytes=budget)
    starts = range(0, t, chunk_tiles)
    assert seen == [(min(chunk_tiles, t - t0) * emax,) * 2 + (t0 * emax,) for t0 in starts]
    dq_1, dkv_1 = sb.stream_backward(q, kv, dsum, *idx, **kw)
    assert torch.equal(dq, dq_1)
    assert torch.equal(dkv, dkv_1)            # the same adds in the same slot order


def test_train_saint_on_padded_layouts_equals_exact_ones(monkeypatch):
    """train_saint builds fixed-capacity layouts (one captured graph per
    budget on the card); on the CPU its history and parameters equal
    those of the same run on exact layouts."""
    rng = np.random.default_rng(1)
    n = 40
    x = (rng.random((n, F)) < 0.2).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    base = dict(x=x, edge_index=np.stack([rng.integers(0, n, 200), rng.integers(0, n, 200)]),
                y=rng.integers(0, 3, n), train_mask=rng.random(n) < 0.5,
                val_mask=rng.random(n) < 0.3, test_mask=rng.random(n) < 0.3)
    full = from_arrays(**base)
    cfg = TrainConfig(learning_rate=1e-2, weight_decay=5e-4, epochs=2, cosine_t0=8,
                      cosine_t_mult=1, checkpoint_every=0, select_best_every=1,
                      num_eval_samples=1, saint_loss="mean", seed=0)
    mcfg = AMPGCNConfig(**{**CFG, "num_sampled_vectors": 5, "dropout_rate": 0.3,
                           "use_pallas": True})
    layouts = []
    real = tloop.compute_layout

    def record(*a, **k):
        lay = real(*a, **k)
        layouts.append(lay)
        return lay

    runs = []
    for exact in (False, True):
        monkeypatch.setattr(tloop, "compute_layout", record if not exact else (
            lambda *a, **k: _live_prefix(real(*a, **k)) if k.get("edges_per_tile")
            else real(*a, **k)))
        model = AMPGCN(mcfg, scaler_stats=fit_scaler(x), device="cpu")
        sampler = GraphSaintRandomWalkSampler(**base, batch_size=6, walk_length=6,
                                              num_steps=4, sample_coverage=5, seed=1)
        runs.append(train_saint(model, sampler, full, cfg, log=Logfile(), prefetch=False))
    sub_layouts = [lay for lay in layouts if lay.recv_slots.numel() ==
                   lay.tile_senders.numel()]
    assert len(sub_layouts) == 8 and any(
        int(lay.recv_ptr[-1]) < lay.recv_slots.numel() for lay in sub_layouts)
    padded, exact = runs
    assert padded["history"] == exact["history"] and len(padded["history"]) == 2
    assert padded["final_metrics"] == exact["final_metrics"]
    for k, v in padded["state"].model.state_dict().items():
        assert torch.equal(v, exact["state"].model.state_dict()[k]), k


def test_optimizer_state_round_trip_and_older_checkpoints():
    """The optimizer's state carries its step count (the rate schedule's
    position); a state saved with the torch scheduler of earlier versions
    takes its count from Adam's own step."""
    def made():
        p = torch.nn.Parameter(torch.zeros(3))
        return p, make_optimizer([p], learning_rate=0.1, cosine_t0=4, cosine_t_mult=1)

    p, opt = made()
    for _ in range(5):
        p.grad = torch.ones(3)
        opt.step()
    saved = opt.state_dict()
    q, fresh = made()
    fresh.load_state_dict(saved)
    assert fresh.count == 5 and fresh.learning_rate == opt.learning_rate
    assert fresh.version == 1 and opt.version == 0
    older = {"adam": saved["adam"], "scheduler": {"last_epoch": 5}}
    q, old = made()
    old.load_state_dict(older)
    assert old.count == 5 and old.rates(3) == opt.rates(3)
