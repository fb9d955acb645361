"""bfloat16 in the port against the JAX package on the CPU: the plain
versions of K1-K4 on bf16 rows and under ``mxu_bf16`` against the Pallas
bodies in interpret mode, the fused op's forward and gradients with
``stream_bf16`` and with bf16 x, the bf16 AMPGCN forward and one whole
training step, the route (row stride, gather, whole-layer kernel) against
the JAX predicates, and the dispatch flags of a captured graph.

Inputs from a numpy seed; n=16, S=4, D=16, H=2, tile_nodes 8; the JAX
kernels' edge group patched to 8 (interpret mode traces a minute per case at
its default). Tolerances, stated per test: the two packages round to bf16
at the same points (the products' operands, the softmax weights, the
projected rows, the layer's mean and output), so the answers differ where a
value sits near a bf16 rounding boundary and the f32 sums before it were
taken in another order: one bf16 step (2**-8 relative) in a few entries.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
from ampnet_tpu.models import AMPGCN as JaxAMPGCN
from ampnet_tpu.ops.edge_attention import MHAParams as JaxParams
from ampnet_tpu.ops.pallas import edge_attention_bwd_scatterfree as jbwd
from ampnet_tpu.ops.pallas import edge_attention_fused as jeaf
from ampnet_tpu.ops.pallas import format as jfmt
from ampnet_tpu.train.losses import masked_mean_nll as jax_masked_mean_nll
from ampnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.edge_attention import MHAParams
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
from ampnet_tpu_torch.ops.hopper import format as fmt
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train import create_train_state, make_optimizer, make_train_step
from ampnet_tpu_torch.train import graphs as capture_graphs
from ampnet_tpu_torch.train.losses import masked_mean_nll

S, D, H, TN = 4, 16, 2, 8
SP16 = 16          # S rounded up to the bf16 row alignment
GROUP = 8
BF = torch.bfloat16


def make_graphs(rng, n=16, e=40):
    """Both packages' padded graphs over one edge list; node n-1 is never a
    receiver and node 0 never a sender."""
    x = (rng.random((n, 6)) < 0.4).astype(np.float32)
    ei = np.stack([rng.integers(1, n, e), rng.integers(0, n - 1, e)])
    kw = dict(pad_nodes_to=n, pad_edges_to=48)
    return jax_from_arrays(x, ei, **kw), from_arrays(x, ei, **kw)


def make_params(rng):
    return [rng.normal(size=s).astype(np.float32) * sc
            for s, sc in (((D, 3 * D), 0.3), ((3 * D,), 0.1), ((D, D), 0.3), ((D,), 0.1))]


def to_bf16(a: np.ndarray):
    """The same bf16 values on both sides."""
    t = torch.from_numpy(a).to(BF)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def close_in_bf16(got, ref, *, steps, what=""):
    """Within ``steps`` bf16 steps (2**-8) of the reference's largest entry."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=steps * 2.0 ** -8 * scale, err_msg=what)


@pytest.fixture
def layouts(rng):
    gj, gt = make_graphs(rng)
    return gj, gt, jfmt.compute_layout(gj, tile_nodes=TN), fmt.compute_layout(gt, tile_nodes=TN)


# ------------------------------------------------------------------ K1


@pytest.mark.parametrize("rows,gather", [("bf16", "vmem"), ("bf16", "dma"), ("mxu", "vmem")])
def test_k1_plain_matches_pallas_in_bf16(rng, layouts, rows, gather):
    """K1's plain version on bf16 rows (both JAX bodies: v2 and v4) and on
    f32 rows under mxu_bf16 (v2, the body that honours it), against
    _fused_edge_sums_v2. The f32 sums of exact bf16 products differ in
    order only, and W can land on the other side of a bf16 rounding
    boundary: held within 1 bf16 step of the largest sum."""
    _, _, lj, lt = layouts
    t, emax = lj.tile_senders.shape
    nt = t * TN
    sp = SP16 if rows == "bf16" else 8
    q = rng.normal(size=(nt * sp, D)).astype(np.float32)
    kv = rng.normal(size=(nt * sp, 2 * D)).astype(np.float32)
    if rows == "bf16":
        (qt, qj), (kvt, kvj) = to_bf16(q), to_bf16(kv)
    else:
        qt, qj, kvt, kvj = torch.from_numpy(q), jnp.asarray(q), torch.from_numpy(kv), jnp.asarray(kv)
    ref = jeaf._fused_edge_sums_v2(
        qj, kvj, lj.tile_senders[:, None, :], lj.tile_recv[:, None, :],
        lj.tile_valid[:, None, :], lj.tile_counts, num_heads=H, softmax=True, tile_nodes=TN,
        group=GROUP, num_tiles=t, emax=emax, s=S, gather=gather, interpret=True,
        mxu_bf16=rows == "mxu")
    got = eaf.edge_attention_sums(qt, kvt, lt.tile_senders, lt.tile_valid, lt.recv_ptr,
                                  lt.recv_slots, s=S, sp=sp, num_heads=H, softmax=True,
                                  mxu_bf16=rows == "mxu")
    assert got.dtype == torch.float32
    got = got.numpy().reshape(nt, sp, D)
    close_in_bf16(got[:, :S], np.asarray(ref).reshape(nt, sp, D)[:, :S], steps=1)
    np.testing.assert_array_equal(got[:, S:], 0.0)
    if rows == "mxu":   # the rounding is real: the f32 products differ
        f32 = eaf.edge_attention_sums(qt, kvt, lt.tile_senders, lt.tile_valid, lt.recv_ptr,
                                      lt.recv_slots, s=S, sp=sp, num_heads=H, softmax=True)
        assert float((f32.reshape(nt, sp, D)[:, :S].numpy() - got[:, :S]).__abs__().max()) > 1e-5


# ------------------------------------------------------------------ K2


@pytest.mark.parametrize("mode", ["bf16", "mxu"])
def test_k2_matches_the_whole_layer_kernel_in_bf16(rng, monkeypatch, layouts, mode):
    """The fused op's forward at gather 'vmem' (v6 usable: K2's plain
    version) against the JAX v6 kernel: bf16 x and weights (bf16 output:
    the mean, the product and the bias each round to bf16), or f32 x under
    mxu_bf16 (the attention's operands only). Held within 2 bf16 steps of
    the largest output: a flipped W or mean moves the rounded product by
    one step, and the bias adds another rounding."""
    monkeypatch.setattr(jeaf, "FUSE_PROJ_DEFAULT", True)
    monkeypatch.setattr(jeaf, "_auto_group", lambda sp, emax, gather: GROUP)
    gj, gt, lj, lt = layouts
    x = rng.normal(size=(16, S, D)).astype(np.float32)
    p = make_params(rng)
    if mode == "bf16":
        xt, xj = to_bf16(x)
        pt = MHAParams(*(to_bf16(a)[0] for a in p))
        pj = JaxParams(*(to_bf16(a)[1] for a in p))
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
        pt, pj = MHAParams(*map(torch.from_numpy, p)), JaxParams(*map(jnp.asarray, p))
    calls = []
    layer = eaf.edge_attention_layer
    monkeypatch.setattr(eaf, "edge_attention_layer",
                        lambda *a, **k: (calls.append(k["mxu_bf16"]), layer(*a, **k))[1])
    ref = jeaf.amp_edge_attention_pallas(
        xj, pj, gj.senders, gj.receivers, gj.edge_mask, lj.tile_senders, lj.tile_recv,
        lj.tile_valid, num_heads=H, tile_nodes=TN, gather="vmem", interpret=True,
        tile_counts=lj.tile_counts, mxu_bf16=mode == "mxu")
    got = eaf.amp_edge_attention_fused(
        xt, pt, gt.receivers, gt.edge_mask, lt.tile_senders, lt.tile_valid, lt.recv_ptr,
        lt.recv_slots, H, tile_nodes=TN, gather="vmem", mxu_bf16=mode == "mxu")
    assert calls == [mode == "mxu"]
    assert got.dtype == (BF if mode == "bf16" else torch.float32) and ref.dtype == xj.dtype
    close_in_bf16(got.float().numpy(), np.asarray(ref, np.float32), steps=2)
    assert (got[15] == 0).all()                 # a receiver of degree 0


# ------------------------------------------------------------------ K3, K4


@pytest.mark.parametrize("softmax", [True, False])
def test_k3_k4_plain_match_passes_r_and_s_in_bf16(rng, layouts, softmax):
    """K3's and K4's plain versions on bf16 rows against _dq_kernel_vmem and
    _dkv_kernel_vmem: f32 dQ and dK|dV from bf16 products. dS and W round to
    bf16 as the products' operands: within 1 bf16 step of the largest
    entry."""
    _, _, lj, lt = layouts
    t, emax = lj.tile_senders.shape
    nt = t * TN
    q, kv = (to_bf16(rng.normal(size=(nt * SP16, w)).astype(np.float32)) for w in (D, 2 * D))
    # dsum's pad token rows are 0 by construction (the JAX bodies gather them)
    dsum = rng.normal(size=(nt, SP16, D)).astype(np.float32)
    dsum[:, S:] = 0.0
    dsum = to_bf16(dsum.reshape(nt * SP16, D))
    ref_dq = jbwd.fused_edge_bwd_dq(
        q[1], kv[1], dsum[1], lj.tile_senders[:, None, :], lj.tile_recv[:, None, :],
        lj.tile_valid[:, None, :], lj.tile_counts, num_heads=H, softmax=softmax,
        tile_nodes=TN, group=GROUP, num_tiles=t, emax=emax, s=S, gather="vmem",
        interpret=True)
    got_dq = bwd.edge_attention_bwd_dq(q[0], kv[0], dsum[0], lt.tile_senders, lt.tile_valid,
                                       lt.recv_ptr, lt.recv_slots, s=S, sp=SP16,
                                       num_heads=H, softmax=softmax)
    ts, emax_s = lj.snd_receivers.shape
    qdm = (torch.cat([q[0], dsum[0]], dim=1), jnp.concatenate([q[1], dsum[1]], axis=1))
    ref_dkv = jbwd.fused_edge_bwd_dkv(
        qdm[1], kv[1], lj.snd_receivers[:, None, :], lj.snd_local[:, None, :],
        lj.snd_valid[:, None, :], lj.snd_counts, num_heads=H, softmax=softmax,
        tile_nodes=TN, group=GROUP, num_tiles=ts, emax=emax_s, s=S, gather="vmem",
        interpret=True)
    got_dkv = bwd.edge_attention_bwd_dkv(qdm[0], kv[0], lt.snd_receivers, lt.snd_valid,
                                         lt.snd_ptr, lt.snd_slots, s=S, sp=SP16,
                                         num_heads=H, softmax=softmax)
    for got, ref, w in ((got_dq, ref_dq, D), (got_dkv, ref_dkv, 2 * D)):
        assert got.dtype == torch.float32
        got = got.numpy().reshape(nt, SP16, w)
        close_in_bf16(got[:, :S], np.asarray(ref).reshape(nt, SP16, w)[:, :S], steps=1)
        np.testing.assert_array_equal(got[:, S:], 0.0)
        assert np.abs(got).max() > 0.1


# ------------------------------------------------------------------ the fused op


@pytest.mark.parametrize("mode,gather", [("stream", "vmem"), ("stream", "dma"),
                                         ("bf16", "vmem")])
def test_fused_op_forward_and_gradients_in_bf16(rng, monkeypatch, layouts, mode, gather):
    """The fused op with the scatter-free backward (K1, then K3 + K4, their
    plain versions) against amp_edge_attention_pallas, forward and the five
    gradients of sum(out * cos(out)): with stream_bf16 on f32 x, and with x
    and the parameters cast to bf16 inside the function (as AMPConv's
    dtype), so the gradients come back to f32 through the casts. Output
    within 2 bf16 steps of its largest entry; gradients within 4 (they pass
    through dsum and dQ / dK|dV, each rounded to bf16 once more)."""
    monkeypatch.setattr(jeaf, "_auto_group", lambda sp, emax, gather: GROUP)
    gj, gt, lj, lt = layouts
    x = rng.normal(size=(16, S, D)).astype(np.float32)
    p = make_params(rng)
    bf16 = mode == "bf16"

    def port(xt, *pt):
        if bf16:
            xt, pt = xt.to(BF), [a.to(BF) for a in pt]
        out = eaf.amp_edge_attention_fused(
            xt, MHAParams(*pt), gt.receivers, gt.edge_mask, lt.tile_senders, lt.tile_valid,
            lt.recv_ptr, lt.recv_slots, H, tile_nodes=TN, gather=gather,
            snd_receivers=lt.snd_receivers, snd_valid=lt.snd_valid, snd_ptr=lt.snd_ptr,
            snd_slots=lt.snd_slots, stream_bf16=mode == "stream").float()
        return out, (out * out.cos()).sum()

    def jax_loss(xj, pj):
        if bf16:
            xj = xj.astype(jnp.bfloat16)
            pj = JaxParams(*(a.astype(jnp.bfloat16) for a in pj))
        out = jeaf.amp_edge_attention_pallas(
            xj, pj, gj.senders, gj.receivers, gj.edge_mask, lj.tile_senders, lj.tile_recv,
            lj.tile_valid, num_heads=H, tile_nodes=TN, gather=gather, interpret=True,
            tile_counts=lj.tile_counts, snd_receivers=lj.snd_receivers,
            snd_local=lj.snd_local, snd_valid=lj.snd_valid, snd_counts=lj.snd_counts,
            scatterfree=True, stream_bf16=mode == "stream").astype(jnp.float32)
        return jnp.sum(out * jnp.cos(out)), out

    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (x, *p)]
    out, loss = port(*leaves)
    loss.backward()
    (loss_j, out_j), (gx, gp) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), JaxParams(*map(jnp.asarray, p)))
    close_in_bf16(out.detach().numpy(), out_j, steps=2, what="out")
    for name, a, b in zip(("x", "w_qkv", "b_qkv", "w_out", "b_out"), leaves, (gx, *gp)):
        assert a.grad.dtype == torch.float32
        close_in_bf16(a.grad.numpy(), b, steps=4, what=name)
    sp = eaf._grid(leaves[0].to(BF) if bf16 else leaves[0], leaves[1], lt.tile_senders,
                   lt.recv_ptr, TN, gather, mode == "stream")[1]
    assert sp == SP16


# ------------------------------------------------------------------ the model

F = 24
CFG = dict(embedding_dim=16, num_heads=2, num_node_features=F, num_sampled_vectors=S,
           output_dim=3, feat_emb_dim=15, val_emb_dim=1, token_sampling="tfidf",
           scaler="precomputed", raw_residual="gcn2", dropout_rate=0.0,
           dropout_adj_rate=0.0, compute_dtype="bfloat16")
RECIPE = dict(learning_rate=3e-3, weight_decay=1e-3, grad_clip=1.0)


def both_models(rng, use_pallas):
    n = 14
    x = (rng.random((n, F)) < 0.3).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n, 40), rng.integers(0, n - 1, 40)])
    split = rng.random(n)
    kw = dict(y=rng.integers(0, 3, n), train_mask=split < 0.4,
              val_mask=(split >= 0.4) & (split < 0.7), test_mask=split >= 0.7,
              pad_nodes_to=16, pad_edges_to=48)
    gj, gt = jax_from_arrays(x, ei, **kw), from_arrays(x, ei, **kw)
    stats = fit_scaler(x)
    cfg = {**CFG, "use_pallas": use_pallas}
    jm = JaxAMPGCN(config=JaxConfig(**cfg), scaler_stats=stats)
    k = jax.random.PRNGKey(0)
    params = jm.init({"params": k, "sample": k, "dropout": k, "edges": k}, gj,
                     return_aux=False)["params"]
    tm = AMPGCN(AMPGCNConfig(**cfg), scaler_stats=stats, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    layouts = ((jfmt.compute_layout(gj, tile_nodes=TN), fmt.compute_layout(gt, tile_nodes=TN))
               if use_pallas else (None, None))
    return jm, params, tm, gj, gt, layouts


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bf16_model_outputs_match_jax(rng, monkeypatch, use_pallas):
    """The bf16 AMPGCN's evaluation forward with the same params and
    sampled_idx: f32 log-probs within 4 bf16 steps of JAX's largest (two
    convs of bf16 roundings, then f32 layers), and every aux output in
    JAX's type (the convs' embeddings bf16 on the fused path, f32 on the
    plain path, where the f32 count promotes the mean)."""
    monkeypatch.setattr(jeaf, "_auto_group", lambda sp, emax, gather: GROUP)
    jm, params, tm, gj, gt, (lj, lt) = both_models(rng, use_pallas)
    idx = rng.integers(0, F, (16, S))
    ref = jm.apply({"params": params}, gj, deterministic=True, sampled_idx=jnp.asarray(idx),
                   edge_layout=lj)
    with torch.no_grad():
        got = tm(gt, sampled_idx=torch.from_numpy(idx), edge_layout=lt, return_aux=True)
    assert got.logits.dtype == torch.float32
    close_in_bf16(got.logits.numpy(), ref.logits, steps=4)
    for key, value in ref.aux.items():
        if key == "sampled_idx":
            continue
        assert str(got.aux[key].dtype).split(".")[-1] == str(value.dtype), key
        close_in_bf16(got.aux[key].float().numpy(), np.asarray(value, np.float32), steps=4,
                      what=key)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bf16_training_step_matches_jax(rng, monkeypatch, use_pallas):
    """One whole training step of the bf16 model (dropout rates 0, the token
    draw injected): the port's make_train_step against value_and_grad +
    optax on the JAX model, plain path and fused path (K1, K3 + K4 plain
    versions; JAX's Pallas bodies in interpret mode). The parameters, their
    gradients and Adam's state stay f32. Loss within 1e-3 relative;
    gradients within 8 bf16 steps of each one's largest entry; the update
    within 5% of the learning rate where the decayed gradient is well above
    Adam's eps and twice the gradient's tolerance (Adam's first step is lr
    * sign(g) there). The plain path
    sums each receiver's bf16 messages in bf16 (JAX's segment_sum in the
    data's type), every add rounding, in another order than XLA's scatter:
    its gradients are held within 32 steps (measured: 11 at most)."""
    monkeypatch.setattr(jeaf, "_auto_group", lambda sp, emax, gather: GROUP)
    jm, params, tm, gj, gt, (lj, lt) = both_models(rng, use_pallas)
    idx = rng.integers(0, F, (16, S))

    def loss_fn(p):
        k = jax.random.PRNGKey(1)
        out = jm.apply({"params": p}, gj, deterministic=False, return_aux=False,
                       sampled_idx=jnp.asarray(idx), edge_layout=lj,
                       rngs={"sample": k, "dropout": k, "edges": k})
        return jax_masked_mean_nll(out.logits, gj.y, gj.train_mask & gj.node_mask)

    loss_j, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = jax_make_optimizer(**RECIPE)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = flax_to_state_dict(jax.device_get(optax.apply_updates(params, updates)))

    tm.zero_grad(set_to_none=True)
    logits = tm(gt, deterministic=False, sampled_idx=torch.from_numpy(idx), edge_layout=lt)
    masked_mean_nll(logits, gt.y, gt.train_mask & gt.node_mask).backward()
    ref = flax_to_state_dict(jax.device_get(grads))
    steps = 8 if use_pallas else 32
    for name, prm in tm.named_parameters():
        assert prm.grad.dtype == torch.float32, name
        close_in_bf16(prm.grad.numpy(), ref[name].numpy(), steps=steps, what=name)

    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    state = create_train_state(tm, make_optimizer(tm.parameters(), **RECIPE), seed=0)
    forward = tm.forward
    tm.forward = lambda g, **kw: forward(g, **{**kw, "sampled_idx": torch.from_numpy(idx),
                                                "edge_layout": lt})
    state, metrics = make_train_step(tm)(state, gt)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_j), rtol=1e-3)
    decayed = {k: ref[k] + RECIPE["weight_decay"] * before[k] for k in ref}
    checked = 0
    for k, v in new_params.items():
        got = dict(tm.named_parameters())[k].detach()
        assert got.dtype == torch.float32
        # well above the gradient's tolerance, where the sign of g is sure
        firm = decayed[k].abs() > 2 * steps * 2.0 ** -8 * float(ref[k].abs().max())
        checked += int(firm.sum())
        np.testing.assert_allclose(got[firm].numpy(), v[firm].numpy(), rtol=0,
                                   atol=0.05 * RECIPE["learning_rate"], err_msg=k)
    assert checked > 0.1 * sum(v.numel() for v in before.values()), checked
    adam = state.optimizer.adam.state
    assert adam and all(adam[p]["exp_avg"].dtype == adam[p]["exp_avg_sq"].dtype == torch.float32
                        for p in tm.parameters())


# ------------------------------------------------------------------ the route

# (nodes, S, tile_nodes): the recipe's padded Cora shape at S=40 and S=20,
# the Predictor's buckets (3,072 nodes: the whole surrogate; 512 and 1,024:
# subgraphs)
SHAPES = [(2752, 40, 256), (2752, 20, 256), (3072, 40, 256), (3072, 20, 256),
          (512, 40, 256), (512, 20, 256), (1024, 40, 256), (1024, 20, 256)]


@pytest.mark.parametrize("n,s,tn", SHAPES)
def test_route_is_the_jax_predicates(n, s, tn):
    """The row stride, the gather and the whole-layer predicate for f32 x,
    bf16 x and stream_bf16 (D=128, H=4) against _stream_align,
    _resolve_gather and _v6_usable; the table's rows pinned where the route
    moves with the type: the 3,072-node bucket at S=20 runs K1 in f32 and K2
    in bf16."""
    d, nt = 128, -(-n // tn) * tn
    tiles = torch.empty(nt // tn, 1, dtype=torch.int32, device="meta")
    ptr = torch.empty(nt + 1, dtype=torch.int32, device="meta")
    w = torch.empty(d, 3 * d, device="meta")
    routes = {}
    for name, dt, stream in (("f32", torch.float32, False), ("bf16", BF, False),
                             ("stream", torch.float32, True)):
        x = torch.empty(n, s, d, dtype=dt, device="meta")
        _, sp, gather = eaf._grid(x, w.to(dt), tiles, ptr, tn, "auto", stream)
        v6 = eaf._v6_usable(n, nt, sp, d, x.element_size(), tn, eaf._auto_group(sp), gather)
        jdt = jnp.bfloat16 if dt == BF else jnp.float32
        jsp = -(-s // jeaf._stream_align(jdt, stream)) * jeaf._stream_align(jdt, stream)
        jg = jeaf._resolve_gather("auto", nt * jsp, d, 2 if stream else jnp.dtype(jdt).itemsize,
                                  tile_rows=tn * jsp)
        jv6 = jeaf._v6_usable(n, nt, jsp, d, jdt, tn, jeaf._auto_group(jsp, 1024, jg), jg,
                              num_heads=4)
        assert (sp, gather, v6) == (jsp, jg, jv6), name
        routes[name] = (sp, gather, v6)
    table = {(2752, 40): {"f32": (40, "dma", False), "bf16": (48, "dma", False)},
             (2752, 20): {"f32": (24, "vmem", True), "bf16": (32, "vmem", True)},
             (3072, 20): {"f32": (24, "vmem", False), "bf16": (32, "vmem", True)}}
    for name, want in table.get((n, s), {}).items():
        assert routes[name] == want, name
    if n <= 1024:
        assert routes["f32"][2] and routes["bf16"][2]


def test_dispatch_flags_follow_the_bf16_environment(monkeypatch):
    """A graph captured under one bf16 setting must not replay under
    another: each flag changes the capture key, and the module constants
    read the JAX package's environment variables."""
    base = capture_graphs.dispatch_flags()
    for flag in ("MXU_BF16_DEFAULT", "STREAM_BF16_DEFAULT"):
        with monkeypatch.context() as m:
            m.setattr(eaf, flag, not getattr(eaf, flag))
            assert capture_graphs.dispatch_flags() != base, flag
    env = {k: v for k, v in os.environ.items() if not k.startswith("AMPNET_")}
    # a fresh process reads each variable at import (the module reloaded
    # there under the other one)
    code = ("import importlib, os; "
            "from ampnet_tpu_torch.ops.hopper import edge_attention_fused as e; "
            "print(e.MXU_BF16_DEFAULT, e.STREAM_BF16_DEFAULT); "
            "os.environ.pop('AMPNET_MXU_BF16'); os.environ['AMPNET_STREAM_BF16'] = '1'; "
            "importlib.reload(e); print(e.MXU_BF16_DEFAULT, e.STREAM_BF16_DEFAULT)")
    out = subprocess.run([sys.executable, "-c", code], env={**env, "AMPNET_MXU_BF16": "1"},
                         capture_output=True, text=True, check=True).stdout.split()
    assert out == ["True", "False", "False", "True"], out
