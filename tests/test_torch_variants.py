"""The port's non-default forward routes (scatter-as-matmul K6 / K7, receiver
chunks K8, packed v1 groups K9) against the JAX package's Pallas bodies in
interpret mode, on the same numpy inputs from a seed: the plain versions of
the four kernels, the chunked layout, the dispatch of the fused op with
``mm_scatter`` and ``DMA_V1_DEFAULT``, the fixed-graph entry points, and the
slice as a whole (AMPGCN logits and one training step's gradients with
``MM_SCATTER_DEFAULT`` on in both packages).

Sizes as the JAX package's own kernel tests: S=4-5, SP=8, D=16, H=2-4, 16-96
nodes, tile_nodes 8-32, JAX group 4 or 8 (the default group traces for a
minute per case). Tolerance: rtol 2e-4 / atol 2e-5, as those tests (f32,
sums taken in another order)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
from ampnet_tpu.models import AMPGCN as JaxAMPGCN
from ampnet_tpu.ops.edge_attention import MHAParams as JaxParams
from ampnet_tpu.ops.edge_attention import amp_edge_attention as jax_amp_edge_attention
from ampnet_tpu.ops.pallas import edge_attention_fused as jeaf
from ampnet_tpu.ops.pallas import format as jfmt
from ampnet_tpu.train.losses import masked_mean_nll as jax_masked_mean_nll
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.edge_attention import MHAParams, amp_edge_attention
from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav
from ampnet_tpu_torch.ops.hopper import format as fmt
from ampnet_tpu_torch.ops.hopper import launch
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train.losses import masked_mean_nll

S, D, H, TN, SP = 4, 16, 2, 8, 8
RTOL, ATOL = 2e-4, 2e-5


def make_graphs(rng, n=16, e=40, n_pad=16, e_pad=48):
    """Both packages' padded graphs over one edge list; node n-1 is never a
    receiver (degree 0)."""
    x = (rng.random((n, 6)) < 0.4).astype(np.float32)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 1, e)])
    kw = dict(pad_nodes_to=n_pad, pad_edges_to=e_pad)
    return jax_from_arrays(x, ei, **kw), from_arrays(x, ei, **kw)


def make_params(rng):
    p = [rng.normal(size=s).astype(np.float32) * sc
         for s, sc in (((D, 3 * D), 0.3), ((3 * D,), 0.1), ((D, D), 0.3), ((D,), 0.1))]
    return JaxParams(*map(jnp.asarray, p)), MHAParams(*map(torch.from_numpy, p))


def runtime_mask(gt, rng, keep=0.8):
    return gt.edge_mask.numpy() & (rng.random(gt.edge_mask.shape[0]) < keep)


def jax_scatter(edge_slot, shape, mask):
    """The JAX AMPConv's scatter of a runtime mask into validity slots."""
    t, width = shape
    slot = jnp.where(edge_slot < 0, t * width, edge_slot)
    flat = jnp.zeros((t * width + 1,), jnp.int32).at[slot].set(mask.astype(jnp.int32))
    return flat[:-1].reshape(t, width)


def rows(rng, nt, cols, sp=SP):
    return rng.normal(size=(nt * sp, cols)).astype(np.float32)


def close(got, ref, nt, s=S, sp=SP, d=D):
    """Real token rows within tolerance; the port's pad token rows exactly 0."""
    got = got.numpy().reshape(nt, sp, d)
    np.testing.assert_allclose(got[:, :s], np.asarray(ref).reshape(nt, sp, d)[:, :s],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[:, s:], 0.0)


def spy(monkeypatch, calls):
    """Record which kernel wrapper the dispatch calls."""
    for mod, names in ((eaf, ("edge_attention_sums", "edge_attention_layer")),
                       (eav, ("edge_attention_sums_mm", "edge_attention_layer_mm",
                              "edge_attention_sums_v1"))):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
                calls.append(_n), _fn(*a, **k))[1])


# ------------------------------------------------------------------ chunked layout


@pytest.mark.parametrize("chunks_per_tile", [0, 128])
def test_build_chunked_csr_matches_jax(rng, chunks_per_tile):
    n, e, tn, c = 64, 200, 16, 4
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    m = rng.random(e) > 0.2
    kw = dict(tile_nodes=tn, chunk_edges=c, chunks_per_tile=chunks_per_tile)
    a, b = jfmt.build_chunked_csr(s, r, m, n, **kw), fmt.build_chunked_csr(s, r, m, n, **kw)
    assert a._fields == b._fields
    for name, fa, fb in zip(a._fields, a, b):
        np.testing.assert_array_equal(np.asarray(fb), np.asarray(fa), err_msg=name)
        if isinstance(fb, np.ndarray):
            assert fb.dtype == np.int32, name
    with pytest.raises(ValueError, match="chunk budget"):
        fmt.build_chunked_csr(s, r, m, n, tile_nodes=64, chunk_edges=1, chunks_per_tile=128)
    with pytest.raises(ValueError, match="multiple of 128"):
        fmt.build_chunked_csr(s, r, m, n, tile_nodes=tn, chunk_edges=c, chunks_per_tile=100)


def test_chunk_index_walks_every_live_chunk_once(rng):
    n, e, tn, c = 64, 300, 16, 3
    s, r = rng.integers(0, n, e), rng.integers(0, n - 1, e)
    m = rng.random(e) > 0.2
    ck = fmt.build_chunked_csr(s, r, m, n, tile_nodes=tn, chunk_edges=c)
    start, count = fmt.chunk_index(ck.chunk_recv, ck.counts, tn)
    deg = np.bincount(r[m], minlength=n)
    np.testing.assert_array_equal(count, -(-deg // c))
    assert count[n - 1] == 0 and count.max() >= 2 and count.sum() == ck.counts.sum()
    seen = []
    for node in range(n):
        for flat in range(start[node], start[node] + count[node]):
            ti, ci = divmod(flat, ck.chunks_per_tile)
            assert ti == node // tn and ck.chunk_recv[ti, ci] == node % tn
            seen.append(flat)
    assert len(set(seen)) == len(seen)
    # every live edge lies in a chunk of its receiver, at its edge_slot
    per_tile = ck.chunks_per_tile * c
    for eid in np.nonzero(m)[0]:
        ti, pos = divmod(int(ck.edge_slot[eid]), per_tile)
        flat = ti * ck.chunks_per_tile + pos // c
        assert start[r[eid]] <= flat < start[r[eid]] + count[r[eid]]
        assert ck.senders[ti, pos] == s[eid]
    with pytest.raises(ValueError, match="receiver-major"):
        fmt.chunk_index(ck.chunk_recv[:, ::-1], np.full_like(ck.counts, ck.chunks_per_tile), tn)


# ------------------------------------------------------------------ K6, K7


@pytest.mark.parametrize("gather", ["vmem", "dma"])
def test_sums_mm_plain_matches_pallas(rng, gather):
    """K6's plain version (port group 3: receivers span groups, the last
    group is ragged) against _fused_kernel_vmem_v2_mm ('vmem') and
    _fused_kernel_dma_v8 ('dma') at JAX group 4, with a runtime mask."""
    gj, gt = make_graphs(rng)
    lj, lt = jfmt.compute_layout(gj, tile_nodes=TN), fmt.compute_layout(gt, tile_nodes=TN)
    t, emax = lj.tile_senders.shape
    nt = t * TN
    q, kv = rows(rng, nt, D), rows(rng, nt, 2 * D)
    mask = runtime_mask(gt, rng)
    vj = jax_scatter(lj.edge_slot, (t, emax), jnp.asarray(mask))
    ref = jeaf._fused_edge_sums_v2(
        jnp.asarray(q), jnp.asarray(kv), lj.tile_senders[:, None, :],
        lj.tile_recv[:, None, :], vj[:, None, :], lj.tile_counts, num_heads=H,
        softmax=True, tile_nodes=TN, group=4, num_tiles=t, emax=emax, s=S,
        gather=gather, interpret=True, mm_scatter=True)
    valid = fmt.edge_slot_valid(lt, torch.from_numpy(mask))
    kw = dict(s=S, sp=SP, num_heads=H, softmax=True, tile_nodes=TN)
    for group in (None, 3):
        got = eav.edge_attention_sums_mm(
            torch.from_numpy(q), torch.from_numpy(kv), lt.tile_senders, lt.tile_recv,
            valid, lt.tile_counts, **kw, group=group)
        close(got, ref, nt)
    assert (got.numpy().reshape(nt, SP, D)[15] == 0).all()


def run_op(rng, monkeypatch, gather, softmax, grad, jax_kw=None, **torch_kw):
    """The fused op in both packages on one graph, x, parameters and runtime
    mask; the port under autograd when ``grad``. Returns (port, JAX, plain
    oracle, zero-degree rows, the port's kernel calls)."""
    gj, gt = make_graphs(rng)
    pj, pt = make_params(rng)
    x = rng.normal(size=(16, S, D)).astype(np.float32)
    lj, lt = jfmt.compute_layout(gj, tile_nodes=TN), fmt.compute_layout(gt, tile_nodes=TN)
    mask = runtime_mask(gt, rng)
    ref = jeaf.amp_edge_attention_pallas(
        jnp.asarray(x), pj, gj.senders, gj.receivers, jnp.asarray(mask),
        lj.tile_senders, lj.tile_recv,
        jax_scatter(lj.edge_slot, lj.tile_valid.shape, jnp.asarray(mask)),
        num_heads=H, softmax=softmax, tile_nodes=TN, gather=gather, interpret=True,
        tile_counts=lj.tile_counts, **(jax_kw or {}))
    calls = []
    spy(monkeypatch, calls)
    got = eaf.amp_edge_attention_fused(
        torch.from_numpy(x).requires_grad_(grad), pt, gt.receivers,
        torch.from_numpy(mask), lt.tile_senders,
        fmt.edge_slot_valid(lt, torch.from_numpy(mask)), lt.recv_ptr, lt.recv_slots, H,
        softmax=softmax, tile_nodes=TN, gather=gather, tile_recv=lt.tile_recv,
        tile_counts=lt.tile_counts, **torch_kw)
    plain, _ = amp_edge_attention(torch.from_numpy(x), gt.senders, gt.receivers,
                                  torch.from_numpy(mask), pt, H, softmax=softmax)
    zero = np.bincount(gt.receivers.numpy()[mask], minlength=16) == 0
    assert zero[15]
    return got.detach().numpy(), np.asarray(ref), plain.numpy(), zero, calls


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("gather,grad,kernel", [
    ("dma", False, "edge_attention_sums_mm"),       # _fused_kernel_dma_v8
    ("vmem", True, "edge_attention_sums_mm"),       # _fused_kernel_vmem_v2_mm
    ("vmem", False, "edge_attention_layer_mm"),     # _fused_kernel_vmem_v6_mm
])
def test_fused_op_mm_scatter_matches_pallas(rng, monkeypatch, gather, grad, kernel, softmax):
    """mm_scatter=True: K6 + torch glue on the 'dma' gather and on every
    forward under autograd (the JAX package with its whole-layer kernel
    switched off runs the same body there), K7 on the v6-eligible no-grad
    route; a receiver of degree 0 comes out exactly 0."""
    if grad:
        monkeypatch.setattr(jeaf, "FUSE_PROJ_DEFAULT", False)
    got, ref, plain, zero, calls = run_op(
        rng, monkeypatch, gather, softmax, grad,
        jax_kw=dict(mm_scatter=True, group=4), mm_scatter=True)
    assert calls == [kernel]
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
    assert (got[zero] == 0.0).all() and (ref[zero] == 0.0).all()


def test_mm_scatter_default_is_read_at_call_time_and_needs_the_slot_arrays(rng, monkeypatch):
    _, gt = make_graphs(rng)
    _, pt = make_params(rng)
    lt = fmt.compute_layout(gt, tile_nodes=TN)
    x = torch.zeros(16, S, D)
    args = (x, pt, gt.receivers, gt.edge_mask, lt.tile_senders, lt.tile_valid,
            lt.recv_ptr, lt.recv_slots, H)
    calls = []
    spy(monkeypatch, calls)
    eaf.amp_edge_attention_fused(*args, tile_nodes=TN)
    monkeypatch.setattr(eaf, "MM_SCATTER_DEFAULT", True)
    eaf.amp_edge_attention_fused(*args, tile_nodes=TN, tile_recv=lt.tile_recv,
                                 tile_counts=lt.tile_counts)
    eaf.amp_edge_attention_fused(*args, tile_nodes=TN, mm_scatter=False)
    assert calls == ["edge_attention_layer", "edge_attention_layer_mm", "edge_attention_layer"]
    with pytest.raises(ValueError, match="tile_recv"):
        eaf.amp_edge_attention_fused(*args, tile_nodes=TN)
    with pytest.raises(ValueError, match="tile_counts"):
        eaf.amp_edge_attention_fused(*args, tile_nodes=TN, tile_recv=lt.tile_recv)


@pytest.mark.parametrize("route,gather,train,s,kernel", [
    ("mm", "dma", False, 96, "edge_attention_sums_mm"),
    ("mm", "auto", False, 96, "edge_attention_layer_mm"),
    ("v1", "dma", False, 96, "edge_attention_sums_v1"),
    ("mm", "dma", True, 64, "edge_attention_sums_mm"),
    ("v1", "dma", True, 64, "edge_attention_sums_v1"),
])
def test_variant_routes_beyond_shared_memory_match_jax_xla(rng, monkeypatch, route, gather,
                                                           train, s, kernel):
    """mm_scatter, and DMA_V1_DEFAULT on a 'dma' gather, at D=16, H=8: an
    eval at S=96, where the CUDA-core bodies of K6 (at group 1) and K9 need
    more than a block's shared memory (on the card they work in device
    memory; K7's attention launch is K6's), and a training step at S=64,
    beyond the tensor cores, where K3 and K4 need more. The fused op runs
    without a warning or a raise and matches the JAX package's XLA edge
    attention on the same inputs, forward and (training) the five gradients
    (rtol 2e-4, atol 1e-5 times the largest entry: f32 sums in another
    order). The tensors lie on the CPU, so each wrapper runs its plain
    version: this shows the dispatch and the plain arithmetic agree with
    JAX, not the route on the card. The route itself is proven on the card
    by test_torch_cuda.py::test_edge_group_kernels_beyond_the_tensor_cores_match_plain
    and by chip_smoke.py's ``routes`` phase."""
    d, h = 16, 8
    monkeypatch.setattr(eaf, "DMA_V1_DEFAULT", route == "v1")
    if train:
        assert launch.tensor_core_range_error(s, d, h) is not None
        assert all(launch.simt_smem_bytes(k, s, d, h) > launch.MAX_SMEM
                   for k in ("edge_attention_bwd_dq", "edge_attention_bwd_dkv"))
    else:
        assert launch.simt_smem_bytes("edge_attention_sums_mm" if route == "mm"
                                      else "edge_attention_sums_v1", s, d, h, 1) > launch.MAX_SMEM
    gj, gt = make_graphs(rng)
    lt = fmt.compute_layout(gt, tile_nodes=TN)
    p = [rng.normal(size=shape).astype(np.float32) * sc
         for shape, sc in (((d, 3 * d), 0.3), ((3 * d,), 0.1), ((d, d), 0.3), ((d,), 0.1))]
    x = rng.normal(size=(16, s, d)).astype(np.float32)
    mask = runtime_mask(gt, rng)
    tmask = torch.from_numpy(mask)
    calls = []
    spy(monkeypatch, calls)
    leaves = [torch.from_numpy(a).requires_grad_(train) for a in (x, *p)]
    with warnings.catch_warnings(), torch.set_grad_enabled(train):
        warnings.simplefilter("error")
        got = eaf.amp_edge_attention_fused(
            leaves[0], MHAParams(*leaves[1:]), gt.receivers, tmask, lt.tile_senders,
            fmt.edge_slot_valid(lt, tmask), lt.recv_ptr, lt.recv_slots, h, tile_nodes=TN,
            gather=gather, snd_receivers=lt.snd_receivers,
            snd_valid=fmt.snd_slot_valid(lt, tmask), snd_ptr=lt.snd_ptr,
            snd_slots=lt.snd_slots, mm_scatter=route == "mm", tile_recv=lt.tile_recv,
            tile_counts=lt.tile_counts)
    assert calls == [kernel]

    def jax_loss(x, *params):
        out, _ = jax_amp_edge_attention(x, gj.senders, gj.receivers, jnp.asarray(mask),
                                        JaxParams(*params), h, return_weights=False)
        return (out * jnp.cos(out)).sum(), out

    (_, ref), grads = jax.value_and_grad(jax_loss, argnums=tuple(range(5)), has_aux=True)(
        *map(jnp.asarray, (x, *p)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    if train:
        (got * got.cos()).sum().backward()
        for name, a, b in zip(("x", "w_qkv", "b_qkv", "w_out", "b_out"), leaves, grads):
            b = np.asarray(b)
            np.testing.assert_allclose(a.grad.numpy(), b, rtol=RTOL,
                                       atol=1e-5 * max(1.0, np.abs(b).max()), err_msg=name)


# ------------------------------------------------------------------ K8


@pytest.mark.parametrize("softmax", [True, False])
def test_sums_chunked_plain_matches_pallas(rng, softmax):
    """K8's plain version against _fused_kernel_chunked: partial and
    multi-chunk receivers, structurally masked edges, and a runtime mask
    scattered through the chunk layout's own edge_slot."""
    n, e, s, d, h, tn, sp, c = 96, 300, 5, 16, 4, 32, 8, 8
    senders, receivers = rng.integers(0, n, e), rng.integers(0, n - 1, e)
    receivers[:30], receivers[30:50] = 3, 50          # receivers of several chunks
    mask = np.ones(e, bool)
    mask[::7] = False
    x = np.zeros((n, 1), np.float32)
    gt = from_arrays(x, np.stack([senders, receivers]), pad_nodes_to=n, pad_edges_to=e)
    gt.edge_mask = torch.from_numpy(mask)
    ck = fmt.compute_chunked_layout(gt, tile_nodes=tn, chunk_edges=c)
    cj = jfmt.build_chunked_csr(senders, receivers, mask, n, tile_nodes=tn, chunk_edges=c)
    assert int(ck.chunk_count.max()) >= 3 and int(ck.chunk_count[n - 1]) == 0
    # run-time drops that leave each chunk its first slot: the JAX body
    # divides inf by inf on a chunk whose every slot is masked at run time
    dropped = mask & ~((cj.edge_slot % c != 0) & (rng.random(e) < 0.4))
    nt = cj.num_tiles * tn
    q, kv = rows(rng, nt, d, sp), rows(rng, nt, 2 * d, sp)
    vj = jax_scatter(jnp.asarray(cj.edge_slot), cj.valid.shape, jnp.asarray(dropped))
    ref = jeaf._fused_edge_sums_chunked(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(cj.senders)[:, None, :],
        jnp.asarray(cj.chunk_recv)[:, None, :], vj[:, None, :], jnp.asarray(cj.counts),
        num_heads=h, softmax=softmax, tile_nodes=tn, chunk=c, num_tiles=cj.num_tiles,
        ncmax=cj.chunks_per_tile, s=s, interpret=True)
    valid = fmt.chunk_slot_valid(ck, torch.from_numpy(dropped))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(vj))
    tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    kw = dict(s=s, sp=sp, num_heads=h, softmax=softmax)
    got = eav.edge_attention_sums_chunked(tq, tkv, ck.senders, valid, ck.chunk_start,
                                          ck.chunk_count, **kw, chunk=c)
    close(got, ref, nt, s, sp, d)
    assert (got.numpy().reshape(nt, sp, d)[n - 1] == 0).all()
    # the same sums as K1's plain version over the tiled layout, also under a
    # mask that empties whole chunks (they contribute exactly 0 here)
    harsh = mask & (rng.random(e) < 0.5)
    emptied = fmt.chunk_slot_valid(ck, torch.from_numpy(harsh)).reshape(-1, c).sum(1)
    assert ((emptied == 0) & (ck.valid.reshape(-1, c).sum(1) > 0)).any()
    lt = fmt.compute_layout(gt, tile_nodes=tn)
    for m in (dropped, harsh):
        m = torch.from_numpy(m)
        got = eav.edge_attention_sums_chunked(
            tq, tkv, ck.senders, fmt.chunk_slot_valid(ck, m), ck.chunk_start,
            ck.chunk_count, **kw, chunk=c)
        k1 = eaf.edge_attention_sums(tq, tkv, lt.tile_senders, fmt.edge_slot_valid(lt, m),
                                     lt.recv_ptr, lt.recv_slots, **kw)
        np.testing.assert_allclose(got.numpy(), k1.numpy(), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ K9


@pytest.mark.parametrize("gather,softmax", [("dma", True), ("dma", False), ("vmem", True)])
def test_sums_v1_plain_matches_pallas(rng, gather, softmax):
    """K9's plain version against _fused_kernel ('dma', a runtime mask: every
    group is walked) and _fused_kernel_vmem ('vmem', structural validity: that
    body skips a group by its first slot), packed groups of 8."""
    gj, gt = make_graphs(rng)
    lj, lt = jfmt.compute_layout(gj, tile_nodes=TN), fmt.compute_layout(gt, tile_nodes=TN)
    t, emax = lj.tile_senders.shape
    nt = t * TN
    q, kv = rows(rng, nt, D), rows(rng, nt, 2 * D)
    mask = runtime_mask(gt, rng) if gather == "dma" else gt.edge_mask.numpy()
    ref = jeaf._fused_edge_sums(
        jnp.asarray(q), jnp.asarray(kv), lj.tile_senders[:, None, :],
        lj.tile_recv[:, None, :],
        jax_scatter(lj.edge_slot, (t, emax), jnp.asarray(mask))[:, None, :],
        num_heads=H, softmax=softmax, tile_nodes=TN, group=8, num_tiles=t, emax=emax,
        s=S, gather=gather, interpret=True)
    got = eav.edge_attention_sums_v1(
        torch.from_numpy(q), torch.from_numpy(kv), lt.tile_senders, lt.tile_recv,
        fmt.edge_slot_valid(lt, torch.from_numpy(mask)), s=S, sp=SP, num_heads=H,
        softmax=softmax, tile_nodes=TN, group=8, gather=gather)
    close(got, ref, nt)
    with pytest.raises(ValueError, match="EMAX"):
        eav.edge_attention_sums_v1(
            torch.from_numpy(q), torch.from_numpy(kv), lt.tile_senders, lt.tile_recv,
            lt.tile_valid, s=S, sp=SP, num_heads=H, softmax=softmax, tile_nodes=TN,
            group=5, gather=gather)


@pytest.mark.parametrize("dma_v1,gather,kernel", [
    (True, "dma", "edge_attention_sums_v1"), (True, "vmem", "edge_attention_layer"),
    (False, "dma", "edge_attention_sums")])
def test_fixed_graph_core_matches_pallas_core(rng, monkeypatch, dma_v1, gather, kernel):
    """amp_edge_attention_fused_core against amp_edge_attention_pallas_core,
    DMA_V1_DEFAULT patched in both packages: K9 on the 'dma' gather only."""
    monkeypatch.setattr(jeaf, "DMA_V1_DEFAULT", dma_v1)
    monkeypatch.setattr(eaf, "DMA_V1_DEFAULT", dma_v1)
    n, e = 16, 40
    x = rng.normal(size=(n, S, D)).astype(np.float32)
    senders = rng.integers(0, n, e).astype(np.int32)
    receivers = np.sort(rng.integers(0, n - 1, e)).astype(np.int32)
    mask = np.ones(e, bool)
    mask[-5:] = False
    pj, pt = make_params(rng)
    ref = jeaf.amp_edge_attention_pallas_core(
        jnp.asarray(x), pj, jfmt.build_tiled_csr(senders, receivers, mask, n, TN, 4),
        jnp.asarray(receivers), jnp.asarray(mask), H, gather=gather, group=4,
        interpret=True)
    calls = []
    spy(monkeypatch, calls)
    got = eaf.amp_edge_attention_fused_core(
        torch.from_numpy(x), pt, fmt.build_tiled_csr(senders, receivers, mask, n, TN, 4),
        torch.from_numpy(receivers), torch.from_numpy(mask), H, gather=gather, group=4)
    assert calls == [kernel] and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert (got.numpy()[15] == 0).all()


@pytest.mark.parametrize("flag", [None, "MM_SCATTER_DEFAULT", "DMA_V1_DEFAULT"])
def test_fixed_graph_closure_forward_and_plain_backward(rng, monkeypatch, flag):
    """make_fused_edge_attention: the forward through the dispatch (whole-
    layer route included, flags read at each call), the five gradients by
    autograd through the plain op."""
    n, e = 16, 40
    senders, receivers = rng.integers(0, n, e), rng.integers(0, n - 1, e)
    mask = rng.random(e) < 0.8
    _, pt = make_params(rng)
    x = torch.from_numpy(rng.normal(size=(n, S, D)).astype(np.float32))
    fn = eaf.make_fused_edge_attention(senders, receivers, mask, n, H, tile_nodes=TN,
                                       gather="dma" if flag == "DMA_V1_DEFAULT" else "auto")
    if flag:
        monkeypatch.setattr(eaf, flag, True)
    calls = []
    spy(monkeypatch, calls)
    leaves = [t.clone().requires_grad_() for t in (x, *pt)]
    out = fn(leaves[0], MHAParams(*leaves[1:]))
    assert calls == [{None: "edge_attention_layer",
                      "MM_SCATTER_DEFAULT": "edge_attention_layer_mm",
                      "DMA_V1_DEFAULT": "edge_attention_sums_v1"}[flag]]
    (out * out.cos()).sum().backward()
    cpu = [t.clone().requires_grad_() for t in (x, *pt)]
    ref, _ = amp_edge_attention(cpu[0], torch.from_numpy(senders), torch.from_numpy(receivers),
                                torch.from_numpy(mask), MHAParams(*cpu[1:]), H)
    (ref * ref.cos()).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=RTOL, atol=ATOL)
    for a, b in zip(leaves, cpu):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=RTOL,
                                   atol=1e-5 * max(1.0, float(b.grad.abs().max())))


# ------------------------------------------------------------------ the slice as a whole

F_, CFG = 24, dict(embedding_dim=16, num_heads=2, num_node_features=24,
                   num_sampled_vectors=S, output_dim=3, feat_emb_dim=15, val_emb_dim=1,
                   token_sampling="tfidf", scaler="precomputed", raw_residual="gcn2",
                   dropout_rate=0.0, dropout_adj_rate=0.0, use_pallas=True)


def test_ampgcn_with_mm_scatter_matches_jax(rng, monkeypatch):
    """AMPGCN with MM_SCATTER_DEFAULT on in both packages: eval logits (K7's
    plain version against the v6-mm body) and one training step's loss and
    parameter gradients (K6 forward, K3 + K4 backward, against v2-mm and the
    Pallas passes R and S in interpret mode)."""
    monkeypatch.setattr(jeaf, "_auto_group", lambda sp, emax, gather: 8)
    monkeypatch.setattr(jeaf, "MM_SCATTER_DEFAULT", True)
    monkeypatch.setattr(eaf, "MM_SCATTER_DEFAULT", True)
    n, e = 14, 40
    x = (rng.random((n, F_)) < 0.3).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 1, e)])
    split = rng.random(n)
    kw = dict(y=rng.integers(0, 3, n), train_mask=split < 0.5, val_mask=split >= 0.5,
              pad_nodes_to=16, pad_edges_to=48)
    gj, gt = jax_from_arrays(x, ei, **kw), from_arrays(x, ei, **kw)
    stats = fit_scaler(x)
    jm = JaxAMPGCN(config=JaxConfig(**CFG), scaler_stats=stats)
    k = jax.random.PRNGKey(0)
    params = jm.init({"params": k, "sample": k, "dropout": k, "edges": k}, gj,
                     return_aux=False)["params"]
    tm = AMPGCN(AMPGCNConfig(**CFG), scaler_stats=stats, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    idx = rng.integers(0, F_, (16, S))
    lj, lt = jfmt.compute_layout(gj, tile_nodes=TN), fmt.compute_layout(gt, tile_nodes=TN)
    calls = []
    spy(monkeypatch, calls)

    ref = jm.apply({"params": params}, gj, return_aux=False,
                   sampled_idx=jnp.asarray(idx), edge_layout=lj).logits
    with torch.no_grad():
        got = tm(gt, sampled_idx=torch.from_numpy(idx), edge_layout=lt)
    assert calls == ["edge_attention_layer_mm"] * 2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)

    def loss_fn(p):
        out = jm.apply({"params": p}, gj, deterministic=False, return_aux=False,
                       sampled_idx=jnp.asarray(idx), edge_layout=lj,
                       rngs={"sample": k, "dropout": k, "edges": k})
        return jax_masked_mean_nll(out.logits, gj.y, gj.train_mask & gj.node_mask)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    del calls[:]
    logits = tm(gt, deterministic=False, sampled_idx=torch.from_numpy(idx), edge_layout=lt,
                generator=torch.Generator().manual_seed(0))
    loss = masked_mean_nll(logits, gt.y, gt.train_mask & gt.node_mask)
    loss.backward()
    assert calls == ["edge_attention_sums_mm"] * 2
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    want = flax_to_state_dict(jax.device_get(grads_j))
    for name, p in tm.named_parameters():
        r = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=RTOL,
                                   atol=2e-6 * max(1.0, np.abs(r).max()), err_msg=name)
