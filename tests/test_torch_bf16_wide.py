"""bfloat16 at every shape the f32 path takes, in the port against the JAX
package on the CPU: the route of all nine kernels onto their bf16 bodies
(the tensor cores' 'tc_bf16' within their range on 16-byte rows, the CUDA
cores' 'simt_bf16' beyond it or on rows the 16-byte copies cannot take, and
the named bodies that still raise); K8's plain version on bf16 K|V against
the JAX chunked body; K1 and K3 + K4 on bf16 rows past the tensor cores'
range (S=49, SP=64, D/H=64) against the Pallas bodies; and a bf16 AMPGCN's
outputs and one training step against JAX's bf16 model at S=49, D=64, H=1
and at D=100, H=4 (bf16 rows of 200 bytes: the contract that D=100 works
holds for a bf16 model).

Inputs from a numpy seed; 16 nodes, tile_nodes 8, the JAX kernels' edge
group patched to 8. The JAX Pallas bodies run in interpret mode for K8 and
for K1, K3 and K4 at S=49; the models' comparison runs JAX's model with
use_pallas as the port's, its Pallas bodies in interpret mode too.
Tolerances are stated in bf16 steps (2**-8) of the reference's largest
entry: the two packages round to bf16 at the same points (q times the bf16
1/sqrt(dh), the softmax weights and dS before their products, the projected
rows, the layer's mean and output), so they differ where a value sits near
a rounding boundary after f32 sums taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
from ampnet_tpu.models import AMPGCN as JaxAMPGCN
from ampnet_tpu.ops.pallas import edge_attention_bwd_scatterfree as jbwd
from ampnet_tpu.ops.pallas import edge_attention_fused as jeaf
from ampnet_tpu.ops.pallas import format as jfmt
from ampnet_tpu.train.losses import masked_mean_nll as jax_masked_mean_nll
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav
from ampnet_tpu_torch.ops.hopper import format as fmt
from ampnet_tpu_torch.ops.hopper import launch
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train.losses import masked_mean_nll

TN, GROUP = 8, 8
BF = torch.bfloat16
STEP = 2.0 ** -8


def to_bf16(a: np.ndarray):
    """The same bf16 values on both sides."""
    t = torch.from_numpy(a).to(BF)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def close_in_bf16(got, ref, *, steps, what=""):
    """Within ``steps`` bf16 steps of the reference's largest entry."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=steps * STEP * scale, err_msg=what)


# ------------------------------------------------------------------ the route

K1, K2, K3, K4, K5, K6, K7, K8, K9 = (
    "edge_attention_sums", "edge_attention_layer", "edge_attention_bwd_dq",
    "edge_attention_bwd_dkv", "edge_attention_bwd_stream", "edge_attention_sums_mm",
    "edge_attention_layer_mm", "edge_attention_sums_chunked", "edge_attention_sums_v1")


def body_of(kernel, named, s, d, h, rows, mxu_bf16=False):
    """The body a wrapper's rule gives; K7's three launches take one body,
    K6's rule where its x_rows, w_qkv and w_out copy in 16-byte pieces too."""
    if kernel == K7:
        x, w_qkv, w_out = (torch.zeros(n, c, dtype=rows.dtype) for n, c in
                           ((64, d), (d, 3 * d), (d, d)))
        return eav.layer_mm_body(named, s, d, h, x, w_qkv, w_out, rows, mxu_bf16)
    return launch.body_of(kernel, named, s, d, h, ("kv_rows", rows), mxu_bf16=mxu_bf16)


@pytest.mark.parametrize("kernel", [K1, K2, K3, K4, K5, K6, K7, K8, K9])
def test_bf16_rows_take_a_bf16_body_at_every_shape(kernel):
    """bf16 rows run 'tc_bf16' within the tensor cores' range on 16-byte
    rows (K1, K3 and K4 up to S=64, the others up to S=48), and 'simt_bf16'
    beyond it (S=49 but for K1, K3 and K4, S=65, D/H=64, 24 warps) or where the
    rows do not take 16-byte copies (D=100: bf16 rows of 200 bytes); f32
    rows under mxu_bf16 take the same two where mxu_bf16 reaches (K1, K2,
    K6, K7). The named bodies that do not take the call still raise:
    'tc_bf16' beyond the range, an f32 body on bf16 rows, a bf16 body on
    f32 rows without mxu_bf16."""
    def rows(d, dtype=BF, aligned=True):
        return torch.zeros(64, 3 * d + (0 if aligned else 1), dtype=dtype)[:, d: 3 * d]

    assert kernel == K7 or kernel in launch.TENSOR_CORE_KERNELS
    assert body_of(kernel, None, 40, 128, 4, rows(128)) == "tc_bf16"
    for s in (49, 64):
        assert body_of(kernel, None, s, 128, 4, rows(128)) == (
            "tc_bf16" if kernel in (K1, K3, K4) else "simt_bf16"), s
    for s, d, h, aligned in ((65, 128, 4, True), (64, 128, 2, True), (40, 128, 8, True),
                             (40, 100, 4, True), (40, 128, 4, False)):
        r = rows(d, aligned=aligned)
        assert body_of(kernel, None, s, d, h, r) == "simt_bf16", (s, d, h)
        assert body_of(kernel, "simt_bf16", s, d, h, r) == "simt_bf16"
    with pytest.raises(ValueError, match="beyond it bf16 runs on 'simt_bf16'"):
        body_of(kernel, "tc_bf16", 65, 128, 4, rows(128))
    for named, r in (("tc", rows(128)), ("simt", rows(128)),
                     ("tc_bf16", rows(128, torch.float32)),
                     ("simt_bf16", rows(128, torch.float32))):
        with pytest.raises(ValueError, match="'tc_bf16' body"):
            body_of(kernel, named, 40, 128, 4, r)
    f32 = rows(128, torch.float32)
    if kernel in (K1, K2, K6, K7):
        assert body_of(kernel, None, 40, 128, 4, f32, mxu_bf16=True) == "tc_bf16"
        assert body_of(kernel, None, 65, 128, 4, f32, mxu_bf16=True) == "simt_bf16"
    else:
        with pytest.raises(ValueError, match="mxu_bf16 reaches"):
            body_of(kernel, None, 49, 128, 4, f32, mxu_bf16=True)


def test_bf16_bodies_keep_the_f32_working_set():
    """The CUDA-core bf16 bodies keep the f32 bodies' working set (bf16
    values are converted as they are loaded): the same bytes a block and
    the same route to device memory; path J's shapes (S=64, D=128, H=4):
    K1 in shared memory, K3 and K4 in device memory."""
    assert launch.simt_smem_bytes(K1, 64, 128, 4) == 197_120 <= launch.MAX_SMEM
    assert launch.simt_smem_bytes(K3, 64, 128, 4) == 295_936 > launch.MAX_SMEM
    assert launch.simt_smem_bytes(K4, 64, 128, 4) == 328_704 > launch.MAX_SMEM
    assert set(launch.SIMT_BODIES) == {"simt", "simt_bf16"}
    assert launch.f32_body("simt_bf16") == "simt" and launch.f32_body("tc_bf16") == "tc"


# ------------------------------------------------------------------ K8


@pytest.mark.parametrize("softmax", [True, False])
def test_k8_plain_matches_the_chunked_body_on_bf16_rows(rng, softmax):
    """K8's plain version on bf16 q and K|V rows against
    _fused_edge_sums_chunked (its K|V buffer in the rows' type, f32 sums),
    at test_torch_variants.py's f32 shape: multi-chunk receivers, partial
    chunks, a runtime mask that leaves each chunk a live slot. Within 1 bf16
    step of the largest sum."""
    n, e, s, d, h, tn, c = 96, 300, 5, 16, 4, 32, 8
    sp = 16                                           # S to the bf16 row alignment
    senders, receivers = rng.integers(0, n, e), rng.integers(0, n - 1, e)
    receivers[:30], receivers[30:50] = 3, 50
    mask = np.ones(e, bool)
    mask[::7] = False
    gt = from_arrays(np.zeros((n, 1), np.float32), np.stack([senders, receivers]),
                     pad_nodes_to=n, pad_edges_to=e)
    gt.edge_mask = torch.from_numpy(mask)
    ck = fmt.compute_chunked_layout(gt, tile_nodes=tn, chunk_edges=c)
    cj = jfmt.build_chunked_csr(senders, receivers, mask, n, tile_nodes=tn, chunk_edges=c)
    dropped = mask & ~((cj.edge_slot % c != 0) & (rng.random(e) < 0.4))
    nt = cj.num_tiles * tn
    (qt, qj), (kvt, kvj) = (to_bf16(rng.normal(size=(nt * sp, w)).astype(np.float32))
                            for w in (d, 2 * d))
    slot = jnp.where(jnp.asarray(cj.edge_slot) < 0, cj.valid.size, jnp.asarray(cj.edge_slot))
    vj = jnp.zeros((cj.valid.size + 1,), jnp.int32).at[slot].set(
        jnp.asarray(dropped).astype(jnp.int32))[:-1].reshape(cj.valid.shape)
    ref = jeaf._fused_edge_sums_chunked(
        qj, kvj, jnp.asarray(cj.senders)[:, None, :], jnp.asarray(cj.chunk_recv)[:, None, :],
        vj[:, None, :], jnp.asarray(cj.counts), num_heads=h, softmax=softmax, tile_nodes=tn,
        chunk=c, num_tiles=cj.num_tiles, ncmax=cj.chunks_per_tile, s=s, interpret=True)
    valid = fmt.chunk_slot_valid(ck, torch.from_numpy(dropped))
    got = eav.edge_attention_sums_chunked(qt, kvt, ck.senders, valid, ck.chunk_start,
                                          ck.chunk_count, s=s, sp=sp, num_heads=h,
                                          softmax=softmax, chunk=c)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    got = got.numpy().reshape(nt, sp, d)
    close_in_bf16(got[:, :s], np.asarray(ref).reshape(nt, sp, d)[:, :s], steps=1)
    np.testing.assert_array_equal(got[:, s:], 0.0)
    assert (got[n - 1] == 0).all() and np.abs(got).max() > 0.1


# ------------------------------------------------------------------ K1, K3, K4 at S=49

S49, SP64, D64, H1 = 49, 64, 64, 1


@pytest.fixture
def wide_layouts(rng):
    n = 16
    x = (rng.random((n, 6)) < 0.4).astype(np.float32)
    ei = np.stack([rng.integers(1, n, 40), rng.integers(0, n - 1, 40)])
    kw = dict(pad_nodes_to=n, pad_edges_to=48)
    gj, gt = jax_from_arrays(x, ei, **kw), from_arrays(x, ei, **kw)
    return jfmt.compute_layout(gj, tile_nodes=TN), fmt.compute_layout(gt, tile_nodes=TN)


def test_k1_k3_k4_plain_match_pallas_past_the_tensor_cores(rng, wide_layouts):
    """K1, K3 and K4 on bf16 rows where the card runs 'simt_bf16' (S=49,
    SP=64, D/H=64): their plain versions against _fused_edge_sums_v2 (the
    'vmem' body), _dq_kernel_vmem and _dkv_kernel_vmem in interpret mode,
    f32 sums within 1 bf16 step of each one's largest entry, pad token rows
    exactly 0."""
    lj, lt = wide_layouts
    assert launch.body(K1, S49, D64, H1, rows_aligned=True, bf16=True) == "simt_bf16"
    t, emax = lj.tile_senders.shape
    nt = t * TN
    (qt, qj), (kvt, kvj) = (to_bf16(rng.normal(size=(nt * SP64, w)).astype(np.float32))
                            for w in (D64, 2 * D64))
    dsum = rng.normal(size=(nt, SP64, D64)).astype(np.float32)
    dsum[:, S49:] = 0.0                               # as the op makes them
    dt, dj = to_bf16(dsum.reshape(nt * SP64, D64))
    kw = dict(num_heads=H1, softmax=True, tile_nodes=TN, group=GROUP, num_tiles=t, emax=emax,
              s=S49, gather="vmem", interpret=True)
    slots = (lj.tile_senders[:, None, :], lj.tile_recv[:, None, :], lj.tile_valid[:, None, :],
             lj.tile_counts)
    ref_sums = jeaf._fused_edge_sums_v2(qj, kvj, *slots, **kw)
    ref_dq = jbwd.fused_edge_bwd_dq(qj, kvj, dj, *slots, **kw)
    ts, emax_s = lj.snd_receivers.shape
    ref_dkv = jbwd.fused_edge_bwd_dkv(
        jnp.concatenate([qj, dj], axis=1), kvj, lj.snd_receivers[:, None, :],
        lj.snd_local[:, None, :], lj.snd_valid[:, None, :], lj.snd_counts,
        **dict(kw, num_tiles=ts, emax=emax_s))
    pkw = dict(s=S49, sp=SP64, num_heads=H1, softmax=True)
    r_idx = (lt.tile_senders, lt.tile_valid, lt.recv_ptr, lt.recv_slots)
    got = {"sums": eaf.edge_attention_sums(qt, kvt, *r_idx, **pkw),
           "dq": bwd.edge_attention_bwd_dq(qt, kvt, dt, *r_idx, **pkw),
           "dkv": bwd.edge_attention_bwd_dkv(torch.cat([qt, dt], 1), kvt, lt.snd_receivers,
                                             lt.snd_valid, lt.snd_ptr, lt.snd_slots, **pkw)}
    for name, ref in (("sums", ref_sums), ("dq", ref_dq), ("dkv", ref_dkv)):
        g = got[name]
        w = g.shape[1]
        assert g.dtype == torch.float32, name
        g = g.numpy().reshape(nt, SP64, w)
        close_in_bf16(g[:, :S49], np.asarray(ref).reshape(nt, SP64, w)[:, :S49], steps=1,
                      what=name)
        np.testing.assert_array_equal(g[:, S49:], 0.0)
        assert np.abs(g).max() > 0.1, name


# ------------------------------------------------------------------ the model

F = 24


def both_models(rng, s, d, h):
    n = 14
    x = (rng.random((n, F)) < 0.3).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n, 40), rng.integers(0, n - 1, 40)])
    split = rng.random(n)
    kw = dict(y=rng.integers(0, 3, n), train_mask=split < 0.4,
              val_mask=(split >= 0.4) & (split < 0.7), test_mask=split >= 0.7,
              pad_nodes_to=16, pad_edges_to=48)
    gj, gt = jax_from_arrays(x, ei, **kw), from_arrays(x, ei, **kw)
    cfg = dict(embedding_dim=d, num_heads=h, num_node_features=F, num_sampled_vectors=s,
               output_dim=3, feat_emb_dim=d - 1, val_emb_dim=1, token_sampling="tfidf",
               scaler="precomputed", raw_residual="gcn2", dropout_rate=0.0,
               dropout_adj_rate=0.0, compute_dtype="bfloat16", use_pallas=True)
    stats = fit_scaler(x)
    jm = JaxAMPGCN(config=JaxConfig(**cfg), scaler_stats=stats)
    k = jax.random.PRNGKey(0)
    params = jm.init({"params": k, "sample": k, "dropout": k, "edges": k}, gj,
                     return_aux=False)["params"]
    tm = AMPGCN(AMPGCNConfig(**cfg), scaler_stats=stats, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    return jm, params, tm, gj, gt, jfmt.compute_layout(gj, tile_nodes=TN), \
        fmt.compute_layout(gt, tile_nodes=TN)


@pytest.mark.parametrize("s,d,h", [(S49, D64, H1), (4, 100, 4)])
def test_bf16_model_past_the_tensor_cores_matches_jax(rng, monkeypatch, s, d, h):
    """A bf16 AMPGCN (compute_dtype='bfloat16') where the card runs every
    kernel on 'simt_bf16': S=49 with D/H=64, and D=100 with H=4, whose bf16
    rows (200 bytes) take no 16-byte copies. Its evaluation logits and one
    training step's gradients (dropout rates 0, the draw injected; K1, then
    K3 + K4, their plain versions) against JAX's bf16 model on its Pallas
    path: logits within 4 bf16 steps of the largest (two convs of bf16
    roundings, then f32 layers), the loss within 1e-3 relative, every
    parameter's gradient within 8 bf16 steps of its largest entry (as the
    bf16 tests at the tensor cores' shapes)."""
    monkeypatch.setattr(jeaf, "_auto_group", lambda sp, emax, gather: GROUP)
    jm, params, tm, gj, gt, lj, lt = both_models(rng, s, d, h)
    sp = -(-s // 16) * 16
    kv = torch.zeros(64, 3 * d, dtype=BF)[:, d:]
    assert launch.body(K1, s, d, h, launch._rows_error([("kv_rows", kv)]) is None,
                       bf16=True) == "simt_bf16"
    assert sp == eaf._grid(torch.empty(16, s, d, dtype=BF), torch.empty(d, 3 * d, dtype=BF),
                           lt.tile_senders, lt.recv_ptr, TN, "auto", False)[1]
    idx = rng.integers(0, F, (16, s))
    ref = jm.apply({"params": params}, gj, deterministic=True, sampled_idx=jnp.asarray(idx),
                   edge_layout=lj, return_aux=False)
    with torch.no_grad():
        got = tm(gt, sampled_idx=torch.from_numpy(idx), edge_layout=lt)
    assert got.dtype == torch.float32
    close_in_bf16(got.numpy(), ref.logits, steps=4, what="logits")

    def loss_fn(p):
        k = jax.random.PRNGKey(1)
        out = jm.apply({"params": p}, gj, deterministic=False, return_aux=False,
                       sampled_idx=jnp.asarray(idx), edge_layout=lj,
                       rngs={"sample": k, "dropout": k, "edges": k})
        return jax_masked_mean_nll(out.logits, gj.y, gj.train_mask & gj.node_mask)

    loss_j, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    logits = tm(gt, deterministic=False, sampled_idx=torch.from_numpy(idx), edge_layout=lt)
    loss = masked_mean_nll(logits, gt.y, gt.train_mask & gt.node_mask)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-3)
    ref_g = flax_to_state_dict(jax.device_get(grads))
    for name, p in tm.named_parameters():
        assert p.grad.dtype == torch.float32, name
        close_in_bf16(p.grad.numpy(), ref_g[name].numpy(), steps=8, what=name)
