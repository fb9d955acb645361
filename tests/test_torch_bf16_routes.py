"""bfloat16 on the routes past K1-K4, in the port against the JAX package on
the CPU: the plain versions of K5 (the stream backward's pass A), K6 (the
scatter-as-matmul sums), K7 (the whole layer by the one-hot product) and K9
(the packed v1 groups) on bf16 rows and, where the JAX body honours it,
under ``mxu_bf16``, against the Pallas bodies in interpret mode; the fused
op's forward and gradients on a layout without a sender side (the stream
backward) and under ``mm_scatter``; one ``make_pallas_train_step`` step (path
F) of a bf16 model against the JAX step.

Inputs from a numpy seed; 16 nodes, S=4 (row stride 16 for bf16 rows, 8 for
f32 rows under mxu_bf16), D=16, H=2, tile_nodes 8; the JAX kernels' edge
group patched to 8 (interpret mode traces a minute per case at its
default). Tolerances are stated in bf16 steps (2**-8) of the reference's
largest entry: the two packages round to bf16 at the same points (q times
the bf16 1/sqrt(dh), the softmax weights and dS before their products, the
projected rows, K7's mean and output), so they differ only where a value
sits near a rounding boundary after f32 sums taken in another order (a
one-hot product, atomics or index_add_ against the JAX loops).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
from ampnet_tpu.data.graphsaint import GraphSaintRandomWalkSampler as JaxSampler
from ampnet_tpu.models import AMPGCN as JaxAMPGCN
from ampnet_tpu.ops.edge_attention import MHAParams as JaxParams
from ampnet_tpu.ops.pallas import edge_attention_bwd as jsb
from ampnet_tpu.ops.pallas import edge_attention_fused as jeaf
from ampnet_tpu.ops.pallas import format as jfmt
from ampnet_tpu.train import create_train_state as jax_create_train_state
from ampnet_tpu.train import pallas_step as jstep
from ampnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.edge_attention import MHAParams
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav
from ampnet_tpu_torch.ops.hopper import format as fmt
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train import create_train_state, make_optimizer, pallas_step

S, D, H, TN = 4, 16, 2, 8
SP16 = 16          # S rounded up to the bf16 row alignment
SP8 = 8            # and to the f32 one (mxu_bf16 keeps f32 rows)
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


def rows(rng, nt, cols, sp, bf16=True, zero_pad_tokens=False):
    """Token rows [nt*sp, cols] for both packages: bf16, or f32."""
    a = rng.normal(size=(nt, sp, cols)).astype(np.float32)
    if zero_pad_tokens:
        a[:, S:] = 0.0
    a = a.reshape(nt * sp, cols)
    return to_bf16(a) if bf16 else (torch.from_numpy(a), jnp.asarray(a))


def close_in_bf16(got, ref, *, steps, what=""):
    """Within ``steps`` bf16 steps (2**-8) of the reference's largest entry."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=steps * 2.0 ** -8 * scale, err_msg=what)


def runtime_mask(rng, gt):
    """Drops ~30% of the live edges."""
    return gt.edge_mask.numpy() & (rng.random(gt.edge_mask.shape[0]) < 0.7)


def jax_scatter(edge_slot, shape, mask):
    """The JAX AMPConv's scatter of a runtime mask into validity slots."""
    t, width = shape
    slot = jnp.where(edge_slot < 0, t * width, edge_slot)
    flat = jnp.zeros((t * width + 1,), jnp.int32).at[slot].set(mask.astype(jnp.int32))
    return flat[:-1].reshape(t, width)


@pytest.fixture
def layouts(rng):
    gj, gt = make_graphs(rng)
    return gj, gt, jfmt.compute_layout(gj, tile_nodes=TN), fmt.compute_layout(gt, tile_nodes=TN)


# ------------------------------------------------------------------ K5


@pytest.mark.parametrize("body", ["vmem_v2", "dma_compact"])
def test_k5_plain_matches_the_stream_bodies_in_bf16(rng, body):
    """K5's plain version on bf16 q, k|v and dsum rows against
    _bwd_kernel_vmem_v2 and _bwd_kernel_dma_compact (softmax on, a runtime
    mask): f32 dQ and an f32 stream, row by row on the live slots through
    the slot -> JAX-row map. dK takes the unscaled bf16 q and the f32 scale
    after its product. Each of dQ, dK and dV within 1 bf16 step of its own
    largest entry."""
    gj, gt = make_graphs(rng)
    lj = jfmt.compute_layout(gj, tile_nodes=TN, sender_layout=False)
    lt = fmt.compute_layout(gt, tile_nodes=TN, sender_layout=False)
    t, emax = lj.tile_senders.shape
    nt = t * TN
    q, kv = rows(rng, nt, D, SP16), rows(rng, nt, 2 * D, SP16)
    dsum = rows(rng, nt, D, SP16, zero_pad_tokens=True)
    mask = runtime_mask(rng, gt)
    vj = jax_scatter(lj.edge_slot, lj.tile_valid.shape, jnp.asarray(mask))
    args = (q[1], kv[1], dsum[1], lj.tile_senders[:, None, :], lj.tile_recv[:, None, :],
            vj[:, None, :])
    kw = dict(num_heads=H, softmax=True, tile_nodes=TN, group=GROUP, num_tiles=t, emax=emax,
              s=S, interpret=True)
    if body == "vmem_v2":
        dq_j, stream_j = jsb.fused_edge_bwd_v2(*args, lj.tile_counts, **kw)
    else:
        dq_j, stream_j = jsb.fused_edge_bwd(*args, gather="dma", dma_v1=False,
                                            tile_counts=lj.tile_counts, **kw)
    assert dq_j.dtype == stream_j.dtype == jnp.float32
    stride = -(-emax // GROUP) * GROUP

    valid = fmt.edge_slot_valid(lt, torch.from_numpy(mask))
    dq, stream = sb.edge_attention_bwd_stream(q[0], kv[0], dsum[0], lt.tile_senders, valid,
                                              lt.recv_ptr, lt.recv_slots, s=S, sp=SP16,
                                              num_heads=H, softmax=True)
    assert dq.dtype == stream.dtype == torch.float32
    dq = dq.numpy().reshape(nt, SP16, D)
    close_in_bf16(dq[:, :S], np.asarray(dq_j).reshape(nt, SP16, D)[:, :S], steps=1, what="dQ")
    np.testing.assert_array_equal(dq[:, S:], 0.0)
    np.testing.assert_array_equal(dq[15], 0.0)          # a receiver of degree 0
    stream = stream.numpy().reshape(t * emax, SP16, 2 * D)
    slots = lt.recv_slots.numpy()
    ref = np.asarray(stream_j).reshape(-1, SP16, 2 * D)[(slots // emax) * stride + slots % emax]
    for half, name in ((slice(0, D), "dK"), (slice(D, 2 * D), "dV")):
        close_in_bf16(stream[slots][:, :S, half], ref[:, :S, half], steps=1, what=name)
        assert np.abs(stream[slots][:, :S, half]).max() > 0.1
    np.testing.assert_array_equal(stream[slots][:, S:], 0.0)


# ------------------------------------------------------------------ K6, K9


@pytest.mark.parametrize("gather,mode", [("vmem", "bf16"), ("dma", "bf16"), ("vmem", "mxu")])
def test_k6_plain_matches_the_mm_bodies_in_bf16(rng, layouts, gather, mode):
    """K6's plain version on bf16 rows against _fused_kernel_vmem_v2_mm
    ('vmem') and _fused_kernel_dma_v8 ('dma'), and on f32 rows under
    mxu_bf16 against v2_mm, the body that honours it (v8 ignores it, and the
    fused op never asks for it there), with a runtime mask: f32 messages
    summed by an f32 one-hot product on both sides. Within 1 bf16 step of
    the largest sum."""
    _, gt, lj, lt = layouts
    t, emax = lj.tile_senders.shape
    nt = t * TN
    sp = SP16 if mode == "bf16" else SP8
    q, kv = rows(rng, nt, D, sp, mode == "bf16"), rows(rng, nt, 2 * D, sp, mode == "bf16")
    mask = runtime_mask(rng, gt)
    vj = jax_scatter(lj.edge_slot, (t, emax), jnp.asarray(mask))
    ref = jeaf._fused_edge_sums_v2(
        q[1], kv[1], lj.tile_senders[:, None, :], lj.tile_recv[:, None, :], vj[:, None, :],
        lj.tile_counts, num_heads=H, softmax=True, tile_nodes=TN, group=4, num_tiles=t,
        emax=emax, s=S, gather=gather, interpret=True, mm_scatter=True,
        mxu_bf16=mode == "mxu")
    valid = fmt.edge_slot_valid(lt, torch.from_numpy(mask))
    kw = dict(s=S, sp=sp, num_heads=H, softmax=True, tile_nodes=TN)
    got = eav.edge_attention_sums_mm(q[0], kv[0], lt.tile_senders, lt.tile_recv, valid,
                                     lt.tile_counts, **kw, mxu_bf16=mode == "mxu")
    assert got.dtype == torch.float32
    got = got.numpy().reshape(nt, sp, D)
    close_in_bf16(got[:, :S], np.asarray(ref).reshape(nt, sp, D)[:, :S], steps=1)
    np.testing.assert_array_equal(got[:, S:], 0.0)
    np.testing.assert_array_equal(got[15], 0.0)
    if mode == "mxu":   # the rounding is real: the f32 products differ
        f32 = eav.edge_attention_sums_mm(q[0], kv[0], lt.tile_senders, lt.tile_recv, valid,
                                         lt.tile_counts, **kw).numpy().reshape(nt, sp, D)
        assert np.abs(f32[:, :S] - got[:, :S]).max() > 1e-5


def test_k9_plain_matches_the_v1_body_in_bf16(rng, layouts):
    """K9's plain version on bf16 rows against _fused_kernel ('dma', a
    runtime mask: every packed group walked, each message scaled by its
    validity and added in f32). Within 1 bf16 step of the largest sum."""
    _, gt, lj, lt = layouts
    t, emax = lj.tile_senders.shape
    nt = t * TN
    q, kv = rows(rng, nt, D, SP16), rows(rng, nt, 2 * D, SP16)
    mask = runtime_mask(rng, gt)
    ref = jeaf._fused_edge_sums(
        q[1], kv[1], lj.tile_senders[:, None, :], lj.tile_recv[:, None, :],
        jax_scatter(lj.edge_slot, (t, emax), jnp.asarray(mask))[:, None, :], num_heads=H,
        softmax=True, tile_nodes=TN, group=8, num_tiles=t, emax=emax, s=S, gather="dma",
        interpret=True)
    got = eav.edge_attention_sums_v1(q[0], kv[0], lt.tile_senders, lt.tile_recv,
                                     fmt.edge_slot_valid(lt, torch.from_numpy(mask)), s=S,
                                     sp=SP16, num_heads=H, softmax=True, tile_nodes=TN,
                                     group=8, gather="dma")
    assert got.dtype == torch.float32
    got = got.numpy().reshape(nt, SP16, D)
    close_in_bf16(got[:, :S], np.asarray(ref).reshape(nt, SP16, D)[:, :S], steps=1)
    np.testing.assert_array_equal(got[:, S:], 0.0)


# ------------------------------------------------------------------ K7


@pytest.mark.parametrize("mode", ["bf16", "mxu"])
def test_k7_matches_the_whole_layer_mm_kernel_in_bf16(rng, monkeypatch, layouts, mode):
    """The fused op's forward under mm_scatter at gather 'vmem' (v6 usable:
    K7's plain version) against _fused_kernel_vmem_v6_mm: bf16 x and
    weights (q|k|v rounded once after the f32 sum and bias, the mean rounded
    to bf16, the out-projection plus the live-row bias summed in f32 and
    rounded once: bf16 output), or f32 x under mxu_bf16 (the attention's
    operands only). Within 2 bf16 steps of the largest output: a flipped W
    or mean moves the product by one step, and the output's rounding adds
    another."""
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
    layer = eav.edge_attention_layer_mm
    monkeypatch.setattr(eav, "edge_attention_layer_mm",
                        lambda *a, **k: (calls.append(k["mxu_bf16"]), layer(*a, **k))[1])
    ref = jeaf.amp_edge_attention_pallas(
        xj, pj, gj.senders, gj.receivers, gj.edge_mask, lj.tile_senders, lj.tile_recv,
        lj.tile_valid, num_heads=H, tile_nodes=TN, gather="vmem", interpret=True,
        tile_counts=lj.tile_counts, mxu_bf16=mode == "mxu", mm_scatter=True)
    got = eaf.amp_edge_attention_fused(
        xt, pt, gt.receivers, gt.edge_mask, lt.tile_senders, lt.tile_valid, lt.recv_ptr,
        lt.recv_slots, H, tile_nodes=TN, gather="vmem", mxu_bf16=mode == "mxu",
        mm_scatter=True, tile_recv=lt.tile_recv, tile_counts=lt.tile_counts)
    assert calls == [mode == "mxu"]
    assert got.dtype == (BF if mode == "bf16" else torch.float32) and ref.dtype == xj.dtype
    close_in_bf16(got.float().numpy(), np.asarray(ref, np.float32), steps=2)
    assert (got[15] == 0).all()                 # a receiver of degree 0


# ------------------------------------------------------------------ the fused op


@pytest.mark.parametrize("mode,gather,mm_scatter", [("bf16", "vmem", False),
                                                    ("stream", "dma", True)])
def test_fused_op_stream_backward_in_bf16(rng, monkeypatch, mode, gather, mm_scatter):
    """The fused op on a layout without a sender side (forward K1, or K6
    under mm_scatter; backward K5 + pass B, their plain versions) against
    amp_edge_attention_pallas without snd_*, forward and the five gradients
    of sum(out * cos(out)): x and the parameters cast to bf16 inside the
    function (as AMPConv's dtype) at gather 'vmem', and stream_bf16 on f32 x
    under mm_scatter at gather 'dma' (v8 forward, the chunked fold of the
    stream). Output within 2 bf16 steps of its largest entry, gradients
    within 4 (they pass through dsum and dQ / dK|dV, each rounded to bf16
    once more)."""
    monkeypatch.setattr(jeaf, "_auto_group", lambda sp, emax, gather: GROUP)
    gj, gt = make_graphs(rng)
    lj = jfmt.compute_layout(gj, tile_nodes=TN, sender_layout=False)
    lt = fmt.compute_layout(gt, tile_nodes=TN, sender_layout=False)
    x = rng.normal(size=(16, S, D)).astype(np.float32)
    p = make_params(rng)
    bf16 = mode == "bf16"
    ran = []
    stream_bwd = sb.edge_attention_bwd_stream
    monkeypatch.setattr(sb, "edge_attention_bwd_stream", lambda *a, **k: (
        ran.append(a[0].dtype), stream_bwd(*a, **k))[1])

    def port(xt, *pt):
        if bf16:
            xt, pt = xt.to(BF), [a.to(BF) for a in pt]
        out = eaf.amp_edge_attention_fused(
            xt, MHAParams(*pt), gt.receivers, gt.edge_mask, lt.tile_senders, lt.tile_valid,
            lt.recv_ptr, lt.recv_slots, H, tile_nodes=TN, gather=gather,
            mm_scatter=mm_scatter, tile_recv=lt.tile_recv, tile_counts=lt.tile_counts,
            stream_bf16=mode == "stream").float()
        return out, (out * out.cos()).sum()

    def jax_loss(xj, pj):
        if bf16:
            xj = xj.astype(jnp.bfloat16)
            pj = JaxParams(*(a.astype(jnp.bfloat16) for a in pj))
        out = jeaf.amp_edge_attention_pallas(
            xj, pj, gj.senders, gj.receivers, gj.edge_mask, lj.tile_senders, lj.tile_recv,
            lj.tile_valid, num_heads=H, tile_nodes=TN, gather=gather, interpret=True,
            tile_counts=lj.tile_counts, mm_scatter=mm_scatter,
            stream_bf16=mode == "stream").astype(jnp.float32)
        return jnp.sum(out * jnp.cos(out)), out

    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (x, *p)]
    out, loss = port(*leaves)
    loss.backward()
    assert ran == [BF]                    # the stream backward, on bf16 rows
    (_, out_j), (gx, gp) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), JaxParams(*map(jnp.asarray, p)))
    close_in_bf16(out.detach().numpy(), out_j, steps=2, what="out")
    for name, a, b in zip(("x", "w_qkv", "b_qkv", "w_out", "b_out"), leaves, (gx, *gp)):
        assert a.grad.dtype == torch.float32
        close_in_bf16(a.grad.numpy(), b, steps=4, what=name)


# ------------------------------------------------------------------ path F

F = 24
CFG = dict(embedding_dim=16, num_heads=2, num_node_features=F, num_sampled_vectors=5,
           output_dim=3, feat_emb_dim=15, val_emb_dim=1, token_sampling="tfidf",
           scaler="precomputed", raw_residual="gcn2", dropout_rate=0.0,
           dropout_adj_rate=0.0, use_pallas=True, compute_dtype="bfloat16")
RECIPE = dict(learning_rate=3e-3, weight_decay=5e-4, grad_clip=1.0)
SAMPLER = dict(batch_size=3, walk_length=4, num_steps=5, sample_coverage=5)


class InjectedDraw:
    """A JAX model whose every apply uses one fixed token draw."""

    def __init__(self, model, idx):
        self.model, self.config, self.idx = model, model.config, idx

    def apply(self, variables, graph, **kw):
        return self.model.apply(variables, graph, sampled_idx=self.idx, **kw)


def test_pallas_train_step_of_a_bf16_model_matches_jax(rng, monkeypatch):
    """Path F in bf16: one make_pallas_train_step step of a bf16 model on a
    sampled subgraph with compute_layout(sender_layout=False), forward K1 and
    backward K5 + pass B on bf16 rows (their plain versions), against the
    JAX step in interpret mode (its backward the stream backward too). The
    parameters and Adam's state stay f32. Loss within 1e-3 relative; the
    update within 5% of the learning rate where the decayed gradient is
    firm: above 16 bf16 steps of its largest entry (Adam's first step is lr
    * sign(g) there, and the gradients of the bf16 step agree within 8
    steps, as the scatter-free step's do)."""
    monkeypatch.setattr(jeaf, "_auto_group", lambda sp, emax, gather: GROUP)
    data = np.random.default_rng(0)
    n = 60
    y = data.integers(0, 3, n)
    x = (data.random((n, F)) < 0.1).astype(np.float32)
    for c in range(3):
        x[y == c, 8 * c: 8 * c + 8] = data.random((int((y == c).sum()), 8)) < 0.6
    x[x.sum(1) == 0, 0] = 1.0
    split = data.random(n)
    base = dict(x=x, edge_index=np.stack([data.integers(0, n, 300), data.integers(0, n, 300)]),
                y=y, train_mask=split < 0.5, val_mask=(split >= 0.5) & (split < 0.75),
                test_mask=split >= 0.75)
    gt = next(iter(GraphSaintRandomWalkSampler(**base, **SAMPLER, seed=1, use_native=False)))
    gj = next(iter(JaxSampler(**base, **SAMPLER, seed=1, use_native=False)))
    lt = pallas_step.compute_layout(gt, tile_nodes=TN, edges_per_tile=128,
                                    sender_layout=False)
    lj = jstep.compute_layout(gj, tile_nodes=TN, edges_per_tile=128, sender_layout=False)
    stats = fit_scaler(x)
    jm = JaxAMPGCN(config=JaxConfig(**CFG), scaler_stats=stats)
    k = jax.random.PRNGKey(0)
    params = jm.init({"params": k, "sample": k, "dropout": k, "edges": k}, gj,
                     return_aux=False)["params"]
    tm = AMPGCN(AMPGCNConfig(**CFG), scaler_stats=stats, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    idx = rng.integers(0, F, (gt.num_nodes_padded, CFG["num_sampled_vectors"]))

    jstate = jax_create_train_state(jm, gj, jax_make_optimizer(**RECIPE), seed=0)
    jstate = jstate.replace(params=params)
    jnew, jmetrics = jstep.make_pallas_train_step(
        InjectedDraw(jm, jnp.asarray(idx)), loss_mode="saint_mean", interpret=True)(
            jstate, gj, lj)

    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    state = create_train_state(tm, make_optimizer(tm.parameters(), **RECIPE), seed=0)
    forward = tm.forward
    tm.forward = lambda g, **kw: forward(g, **{**kw, "sampled_idx": torch.from_numpy(idx)})
    ran = []
    stream_bwd = sb.edge_attention_bwd_stream
    monkeypatch.setattr(sb, "edge_attention_bwd_stream", lambda *a, **k: (
        ran.append(a[0].dtype), stream_bwd(*a, **k))[1])
    state, metrics = pallas_step.make_pallas_train_step(tm, loss_mode="saint_mean")(
        state, gt, lt)
    assert ran == [BF, BF] and state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-3)

    checked = 0
    named = dict(tm.named_parameters())
    for k, v in flax_to_state_dict(jax.device_get(jnew.params)).items():
        got = named[k].detach()
        assert got.dtype == torch.float32, k
        # the clipped gradient is still in .grad; decayed as Adam saw it
        g = named[k].grad + RECIPE["weight_decay"] * before[k]
        firm = g.abs() > 16 * 2.0 ** -8 * float(g.abs().max())
        checked += int(firm.sum())
        np.testing.assert_allclose(got[firm].numpy(), v[firm].numpy(), rtol=0,
                                   atol=0.05 * RECIPE["learning_rate"], err_msg=k)
        assert float((got - before[k]).abs().max()) <= RECIPE["learning_rate"] * 1.001, k
    assert checked > 0.3 * sum(v.numel() for v in before.values()), checked
    adam = state.optimizer.adam.state
    assert adam and all(adam[p]["exp_avg"].dtype == torch.float32 for p in tm.parameters())
