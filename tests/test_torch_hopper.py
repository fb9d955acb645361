"""The port's fused edge-attention op and its layout against the JAX
package: layouts array-equal; the plain versions of the Hopper kernels
against the Pallas kernels in interpret mode (gather 'vmem', 'dma' and the
v6 whole-layer branch), at n=16, S=4, D=16, H=2, tile_nodes=8.

Tolerance: rtol 2e-4 / atol 2e-5 per conv, as the JAX package's own
kernel tests (f32, sums taken in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
from ampnet_tpu.ops.edge_attention import MHAParams as JaxParams
from ampnet_tpu.ops.pallas import edge_attention_fused as jeaf
from ampnet_tpu.ops.pallas import format as jfmt
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.ops.edge_attention import MHAParams, amp_edge_attention
from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
from ampnet_tpu_torch.ops.hopper import format as fmt

S, D, H, TN = 4, 16, 2, 8
SP = 8            # S rounded up to the JAX package's f32 row alignment
RTOL, ATOL = 2e-4, 2e-5


def make_graphs(rng, n=16, e=40, n_pad=16, e_pad=48):
    """Both packages' padded graphs over one edge list; node n-1 is never
    a receiver (degree 0)."""
    x = (rng.random((n, 6)) < 0.4).astype(np.float32)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 1, e)])
    kw = dict(pad_nodes_to=n_pad, pad_edges_to=e_pad)
    return jax_from_arrays(x, ei, **kw), from_arrays(x, ei, **kw)


def make_params(rng):
    p = [rng.normal(size=s).astype(np.float32) * sc
         for s, sc in (((D, 3 * D), 0.3), ((3 * D,), 0.1), ((D, D), 0.3), ((D,), 0.1))]
    return JaxParams(*map(jnp.asarray, p)), MHAParams(*map(torch.from_numpy, p))


def jax_runtime_valid(layout, edge_mask):
    """The JAX AMPConv's scatter of a runtime mask (layers.py:111-125)."""
    t, emax = layout.tile_valid.shape
    slot = jnp.where(layout.edge_slot < 0, t * emax, layout.edge_slot)
    flat = jnp.zeros((t * emax + 1,), jnp.int32).at[slot].set(edge_mask.astype(jnp.int32))
    return flat[:-1].reshape(t, emax)


# ------------------------------------------------------------------ layout


@pytest.mark.parametrize("edges_per_tile", [0, 128])
def test_compute_layout_matches_jax(rng, edges_per_tile):
    gj, gt = make_graphs(rng)
    lj = jfmt.compute_layout(gj, tile_nodes=TN, edges_per_tile=edges_per_tile)
    lt = fmt.compute_layout(gt, tile_nodes=TN, edges_per_tile=edges_per_tile)
    assert lt.tile_nodes == lj.tile_nodes
    for name in ("tile_senders", "tile_recv", "tile_valid", "tile_counts",
                 "edge_slot", "snd_receivers", "snd_local", "snd_valid",
                 "snd_counts", "snd_edge_slot"):
        a, b = np.asarray(getattr(lj, name)), getattr(lt, name).numpy()
        assert b.dtype == np.int32, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_build_tiled_csr_and_budget_match_jax(rng):
    s, r = rng.integers(0, 40, 300), rng.integers(0, 40, 300)
    m = rng.random(300) < 0.9
    for kw in (dict(), dict(group=4), dict(edges_per_tile=256)):
        a, b = jfmt.build_tiled_csr(s, r, m, 40, tile_nodes=8, **kw), \
            fmt.build_tiled_csr(s, r, m, 40, tile_nodes=8, **kw)
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(fb), np.asarray(fa))
    for args in ((10624, 11), (10624, 43, 2.0, 3), (100, 1, 1.5)):
        assert fmt.default_edge_budget(*args) == jfmt.default_edge_budget(*args)
    with pytest.raises(ValueError, match="budget"):
        fmt.build_tiled_csr(s, r, m, 40, tile_nodes=40, edges_per_tile=128)


def test_slot_space_overflow_raises():
    # 2**14 tiles x 2**17 slots = 2**31: raised before anything is allocated
    with pytest.raises(ValueError, match="overflows int32"):
        fmt.build_tiled_csr(np.zeros(1, np.int32), np.zeros(1, np.int32),
                            np.ones(1, bool), 2**14, tile_nodes=1,
                            edges_per_tile=2**17)


def test_receiver_index_walks_every_live_slot_once(rng):
    _, gt = make_graphs(rng)
    lt = fmt.compute_layout(gt, tile_nodes=TN)
    ptr, slots = lt.recv_ptr.numpy(), lt.recv_slots.numpy()
    emax = lt.tile_senders.shape[1]
    t_of, pos = slots // emax, slots % emax
    assert ptr[0] == 0 and ptr[-1] == len(slots) == int(lt.tile_counts.sum())
    assert len(set(slots.tolist())) == len(slots)
    assert (pos < lt.tile_counts.numpy()[t_of]).all()
    recv_of_slot = t_of * TN + lt.tile_recv.numpy()[t_of, pos]
    expect = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    np.testing.assert_array_equal(recv_of_slot, expect)
    # input order within a receiver: slots ascend
    for n in range(len(ptr) - 1):
        assert (np.diff(slots[ptr[n]:ptr[n + 1]]) > 0).all()
    # the multiset of (sender, receiver) pairs is the graph's live edges
    snd = lt.tile_senders.numpy().reshape(-1)[slots]
    m = gt.edge_mask.numpy()
    assert sorted(zip(snd, recv_of_slot)) == sorted(
        zip(gt.senders.numpy()[m], gt.receivers.numpy()[m]))


def test_runtime_mask_scatter_matches_jax(rng):
    gj, gt = make_graphs(rng)
    lj = jfmt.compute_layout(gj, tile_nodes=TN)
    lt = fmt.compute_layout(gt, tile_nodes=TN)
    mask = gt.edge_mask.numpy() & (rng.random(gt.edge_mask.shape[0]) < 0.7)
    np.testing.assert_array_equal(
        fmt.edge_slot_valid(lt, torch.from_numpy(mask)).numpy(),
        np.asarray(jax_runtime_valid(lj, jnp.asarray(mask))))


# ------------------------------------------------------------------ dispatch


@pytest.mark.parametrize("n,s,tn,gather", [
    (2752, 20, 256, "auto"), (2752, 40, 256, "auto"), (16, 4, 8, "auto"),
    (16, 4, 8, "dma"), (100_000, 20, 256, "auto"), (2752, 20, 256, "vmem"),
])
def test_dispatch_predicates_match_jax(n, s, tn, gather):
    nt = -(-n // tn) * tn
    sp = -(-s // 8) * 8
    ours = eaf._resolve_gather(gather, nt * sp, 128, 4, tile_rows=tn * sp)
    assert ours == jeaf._resolve_gather(gather, nt * sp, 128, 4, tile_rows=tn * sp)
    group = eaf._auto_group(sp)
    assert group == jeaf._auto_group(sp, 1024, ours)
    assert eaf._v6_usable(n, nt, sp, 128, 4, tn, group, ours) == jeaf._v6_usable(
        n, nt, sp, 128, jnp.float32, tn, group, ours, num_heads=4)


def test_cora_dispatch_is_v6_at_s20_and_sums_at_s40():
    """The recommended recipe (S=40) runs K1, the reference recipe (S=20)
    K2, as the JAX package runs v4 and v6 there."""
    nt = 11 * 256
    picks = {}
    for s in (20, 40):
        sp = -(-s // 8) * 8
        g = eaf._resolve_gather("auto", nt * sp, 128, 4, tile_rows=256 * sp)
        picks[s] = (sp, g, eaf._auto_group(sp),
                    eaf._v6_usable(2752, nt, sp, 128, 4, 256, eaf._auto_group(sp), g))
    assert picks == {20: (24, "vmem", 32, True), 40: (40, "dma", 19, False)}


# ------------------------------------------------------------------ kernels


def random_rows(rng, nt, cols):
    return rng.normal(size=(nt * SP, cols)).astype(np.float32)


@pytest.mark.parametrize("softmax", [True, False])
def test_edge_attention_sums_plain_matches_pallas_vmem(rng, softmax):
    """K1's plain version against _fused_kernel_vmem_v2 (gather 'vmem')
    on the same projected rows, with a runtime-masked edge."""
    gj, gt = make_graphs(rng)
    lj = jfmt.compute_layout(gj, tile_nodes=TN)
    lt = fmt.compute_layout(gt, tile_nodes=TN)
    nt = lj.tile_senders.shape[0] * TN
    q, kv = random_rows(rng, nt, D), random_rows(rng, nt, 2 * D)
    mask = gt.edge_mask.numpy().copy()
    mask[np.nonzero(mask)[0][3]] = False
    vj = jax_runtime_valid(lj, jnp.asarray(mask))
    t, emax = lj.tile_senders.shape
    ref = jeaf._fused_edge_sums_v2(
        jnp.asarray(q), jnp.asarray(kv), lj.tile_senders[:, None, :],
        lj.tile_recv[:, None, :], vj[:, None, :], lj.tile_counts,
        num_heads=H, softmax=softmax, tile_nodes=TN, group=jeaf._auto_group(SP, emax, "vmem"),
        num_tiles=t, emax=emax, s=S, gather="vmem", interpret=True)
    got = eaf.edge_attention_sums(
        torch.from_numpy(q), torch.from_numpy(kv), lt.tile_senders,
        fmt.edge_slot_valid(lt, torch.from_numpy(mask)), lt.recv_ptr,
        lt.recv_slots, s=S, sp=SP, num_heads=H, softmax=softmax)
    np.testing.assert_allclose(
        got.numpy().reshape(nt, SP, D)[:, :S],
        np.asarray(ref).reshape(nt, SP, D)[:, :S], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy().reshape(nt, SP, D)[:, S:], 0.0)


def run_both(rng, gather, softmax):
    gj, gt = make_graphs(rng)
    pj, pt = make_params(rng)
    x = rng.normal(size=(16, S, D)).astype(np.float32)
    lj = jfmt.compute_layout(gj, tile_nodes=TN)
    lt = fmt.compute_layout(gt, tile_nodes=TN)
    mask = gt.edge_mask.numpy().copy()
    # drop the only in-edge of some receiver at run time: it must come out 0
    deg = np.bincount(gt.receivers.numpy()[mask], minlength=16)
    live = np.nonzero(mask)[0]
    lone = [e for e in live if deg[gt.receivers.numpy()[e]] == 1]
    dropped = lone[0] if lone else live[3]
    mask[dropped] = False
    ref = jeaf.amp_edge_attention_pallas(
        jnp.asarray(x), pj, gj.senders, gj.receivers, jnp.asarray(mask),
        lj.tile_senders, lj.tile_recv, jax_runtime_valid(lj, jnp.asarray(mask)),
        num_heads=H, softmax=softmax, tile_nodes=TN, gather=gather,
        interpret=True, tile_counts=lj.tile_counts)
    got = eaf.amp_edge_attention_fused(
        torch.from_numpy(x), pt, gt.receivers, torch.from_numpy(mask),
        lt.tile_senders, fmt.edge_slot_valid(lt, torch.from_numpy(mask)),
        lt.recv_ptr, lt.recv_slots, H, softmax=softmax, tile_nodes=TN,
        gather=gather)
    plain, _ = amp_edge_attention(torch.from_numpy(x), gt.senders, gt.receivers,
                                  torch.from_numpy(mask), pt, H, softmax=softmax)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)
    zero = np.bincount(gt.receivers.numpy()[mask], minlength=16) == 0
    assert zero[15] and zero.sum() >= 1 + bool(lone)
    assert (got.numpy()[zero] == 0.0).all() and (np.asarray(ref)[zero] == 0.0).all()


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("gather,branch,jax_v6", [
    ("dma", "sums", True), ("vmem", "layer", True), ("vmem", "layer", False)])
def test_fused_op_matches_pallas(rng, monkeypatch, gather, branch, jax_v6, softmax):
    """gather='dma' runs K1 + torch glue against _fused_kernel_vmem_v4;
    gather='vmem' runs K2 against the v6 whole-layer kernel and, with the
    JAX package's v6 switched off, against _fused_kernel_vmem_v2 + XLA glue
    (the same function)."""
    monkeypatch.setattr(jeaf, "FUSE_PROJ_DEFAULT", jax_v6)
    calls = []
    for name in ("edge_attention_sums", "edge_attention_layer"):
        fn = getattr(eaf, name)
        monkeypatch.setattr(eaf, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n.split("_")[-1]), _fn(*a, **k))[1])
    run_both(rng, gather, softmax)
    assert calls == [branch]


def test_fused_op_rejects_mismatched_tile_nodes(rng):
    _, gt = make_graphs(rng)
    _, pt = make_params(rng)
    lt = fmt.compute_layout(gt, tile_nodes=TN)
    x = torch.zeros(16, S, D)
    with pytest.raises(ValueError, match="tile_nodes"):
        eaf.amp_edge_attention_fused(x, pt, gt.receivers, gt.edge_mask,
                                     lt.tile_senders, lt.tile_valid, lt.recv_ptr,
                                     lt.recv_slots, H, tile_nodes=4)


def test_fused_op_is_forward_only(rng):
    """Without the sender side of the layout the op is no longer
    forward-only: the same call now goes backward through the stream
    backward and yields the gradients of the scatter-free backward."""
    _, gt = make_graphs(rng)
    _, pt = make_params(rng)
    l0 = fmt.compute_layout(gt, tile_nodes=TN, sender_layout=False)
    lt = fmt.compute_layout(gt, tile_nodes=TN)
    x0 = torch.randn(16, S, D)
    grads = []
    for lay, snd in ((l0, {}), (lt, dict(snd_receivers=lt.snd_receivers,
                                         snd_valid=lt.snd_valid, snd_ptr=lt.snd_ptr,
                                         snd_slots=lt.snd_slots))):
        x = x0.clone().requires_grad_()
        out = eaf.amp_edge_attention_fused(x, pt, gt.receivers, gt.edge_mask,
                                           lay.tile_senders, lay.tile_valid,
                                           lay.recv_ptr, lay.recv_slots, H,
                                           tile_nodes=TN, **snd)
        out.sum().backward()
        grads.append(x.grad)
    assert float(grads[0].abs().max()) > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)
