"""The port's stream backward (pass A + pass B) against the JAX package:
the plain version of K5 against each of the four Pallas pass-A bodies in
interpret mode (dq rows and the per-edge dK|dV stream, softmax on and off),
and the fused op's five gradients on layouts without a sender side against
jax.grad through ``amp_edge_attention_pallas`` without ``snd_*``, against
the port's own scatter-free backward and against ``fused_bwd=False``.

Sizes: 13-32 nodes, S=5 (row stride SP=8 > S), D=16, H=2, tile_nodes 4-8.
Tolerances: pass A alone rtol/atol 1e-5 (f32, the same per-edge math); the
op's gradients rtol 2e-4 with atol 2e-5 times the gradient's largest entry
(they pass through two projections and a cos-weighted cotangent of size
~100), as for the scatter-free backward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
from ampnet_tpu.ops.edge_attention import MHAParams as JaxParams
from ampnet_tpu.ops.pallas import edge_attention_bwd as jsb
from ampnet_tpu.ops.pallas import edge_attention_fused as jeaf
from ampnet_tpu.ops.pallas import format as jfmt
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.ops.edge_attention import MHAParams, amp_edge_attention
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
from ampnet_tpu_torch.ops.hopper import format as fmt
from ampnet_tpu_torch.ops.segment import segment_sum_into

S, SP, H = 5, 8, 2
# the JAX kernels' edge-group size: a TPU tiling knob (their default, 96 at
# SP=8, only makes interpret mode slow to trace); the math does not depend on it
GROUP = 8
NAMES = ("x", "w_qkv", "b_qkv", "w_out", "b_out")


def make_graphs(rng, n=16, e=40, n_pad=16, e_pad=48):
    """Both packages' padded graphs over one edge list; node n-1 is never
    a receiver and node 0 never a sender (degree 0 on each side)."""
    x = (rng.random((n, 6)) < 0.4).astype(np.float32)
    ei = np.stack([rng.integers(1, n, e), rng.integers(0, n - 1, e)])
    kw = dict(pad_nodes_to=n_pad, pad_edges_to=e_pad)
    return jax_from_arrays(x, ei, **kw), from_arrays(x, ei, **kw)


def runtime_mask(rng, gt):
    """Drops ~30% of the live edges, the first slot of tile 0 among them."""
    mask = gt.edge_mask.numpy() & (rng.random(gt.edge_mask.shape[0]) < 0.7)
    mask[np.argsort(gt.receivers.numpy(), kind="stable")[0]] = False
    return mask


def jax_scatter(edge_slot, shape, mask):
    t, emax = shape
    slot = jnp.where(edge_slot < 0, t * emax, edge_slot)
    flat = jnp.zeros((t * emax + 1,), jnp.int32).at[slot].set(mask.astype(jnp.int32))
    return flat[:-1].reshape(t, emax)


def rows(rng, nt, cols, zero_pad_tokens=False):
    a = rng.normal(size=(nt, SP, cols)).astype(np.float32)
    if zero_pad_tokens:
        a[:, S:] = 0.0
    return a.reshape(nt * SP, cols)


# ------------------------------------------------------------------ pass A


def jax_pass_a(body, args, kw, counts):
    """(dq, stream, the stream's slot stride) of one JAX pass-A body."""
    emax = kw["emax"]
    eg = -(-emax // GROUP) * GROUP
    if body == "vmem_v2":
        return (*jsb.fused_edge_bwd_v2(*args, counts, **kw), eg)
    if body == "dma_compact":
        return (*jsb.fused_edge_bwd(*args, gather="dma", dma_v1=False,
                                    tile_counts=counts, **kw), eg)
    if body == "dma_v1":
        return (*jsb.fused_edge_bwd(*args, gather="dma", dma_v1=True,
                                    tile_counts=counts, **kw), emax)
    return (*jsb.fused_edge_bwd(*args, gather="vmem", tile_counts=counts, **kw), emax)


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("body", ["vmem_v2", "dma_compact", "dma_v1", "vmem"])
def test_stream_plain_matches_pallas_pass_a(rng, body, softmax):
    """K5's plain version against _bwd_kernel_vmem_v2, _bwd_kernel_dma_compact,
    _bwd_kernel_dma and _bwd_kernel_vmem: the dQ rows, and the stream row by
    row on the live slots through the slot -> JAX-row map (slot (t, j) at
    row (t*stride + j)*SP, stride EG for the compact bodies, EMAX else),
    under a runtime mask with structural trip counts."""
    d = 16
    gj, gt = make_graphs(rng)
    lj = jfmt.compute_layout(gj, tile_nodes=8, sender_layout=False)
    lt = fmt.compute_layout(gt, tile_nodes=8, sender_layout=False)
    t, emax = lj.tile_senders.shape
    nt = t * 8
    q, kv, dsum = rows(rng, nt, d), rows(rng, nt, 2 * d), rows(rng, nt, d, True)
    mask = runtime_mask(rng, gt)
    vj = jax_scatter(lj.edge_slot, lj.tile_valid.shape, jnp.asarray(mask))
    args = (jnp.asarray(q), jnp.asarray(kv), jnp.asarray(dsum),
            lj.tile_senders[:, None, :], lj.tile_recv[:, None, :], vj[:, None, :])
    kw = dict(num_heads=H, softmax=softmax, tile_nodes=8, group=GROUP,
              num_tiles=t, emax=emax, s=S, interpret=True)
    dq_j, stream_j, stride = jax_pass_a(body, args, kw, lj.tile_counts)

    valid = fmt.edge_slot_valid(lt, torch.from_numpy(mask))
    dq, stream = sb.edge_attention_bwd_stream(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(dsum),
        lt.tile_senders, valid, lt.recv_ptr, lt.recv_slots,
        s=S, sp=SP, num_heads=H, softmax=softmax)
    dq = dq.numpy().reshape(nt, SP, d)
    np.testing.assert_allclose(dq[:, :S], np.asarray(dq_j).reshape(nt, SP, d)[:, :S],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(dq[:, S:], 0.0)
    np.testing.assert_array_equal(dq[15], 0.0)          # receiver of degree 0

    assert stream.shape == (t * emax * SP, 2 * d)
    stream = stream.numpy().reshape(t * emax, SP, 2 * d)
    slots = lt.recv_slots.numpy()
    jrows = (slots // emax) * stride + slots % emax
    ref = np.asarray(stream_j).reshape(-1, SP, 2 * d)[jrows]
    np.testing.assert_allclose(stream[slots][:, :S], ref[:, :S], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(stream[slots][:, S:], 0.0)
    dropped = valid.numpy().reshape(-1)[slots] == 0
    assert dropped.any() and not dropped.all()
    np.testing.assert_array_equal(stream[slots][dropped], 0.0)   # walked, weighted 0
    assert np.abs(stream[slots][~dropped]).max() > 0.1
    # the dq rows equal pass R's (K3's plain version) on the same inputs
    dq_r = bwd.edge_attention_bwd_dq(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(dsum),
        lt.tile_senders, valid, lt.recv_ptr, lt.recv_slots,
        s=S, sp=SP, num_heads=H, softmax=softmax)
    np.testing.assert_allclose(dq.reshape(nt * SP, d), dq_r.numpy(), rtol=1e-6, atol=1e-6)


def test_stream_over_a_tile_range_and_pass_b(rng):
    """A launch over tiles [t0, t1) gives that range's dQ rows and stream
    rows counted from slot t0*EMAX; pass B over the walked slots of every
    range sums to pass S (K4's plain version) on the sender side."""
    d = 16
    _, gt = make_graphs(rng, n=29, e=90, n_pad=32, e_pad=128)
    lt = fmt.compute_layout(gt, tile_nodes=8)
    t, emax = lt.tile_senders.shape
    nt = t * 8
    q, kv, dsum = (torch.from_numpy(a) for a in
                   (rows(rng, nt, d), rows(rng, nt, 2 * d), rows(rng, nt, d, True)))
    idx = (lt.tile_senders, lt.tile_valid, lt.recv_ptr, lt.recv_slots)
    kw = dict(s=S, sp=SP, num_heads=H, softmax=True)
    dq_all, stream_all = sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw)
    dq_part, stream_part = sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw, tiles=(1, 3))
    assert dq_part.shape == (2 * 8 * SP, d) and stream_part.shape == (2 * emax * SP, 2 * d)
    torch.testing.assert_close(dq_part, dq_all[8 * SP: 24 * SP], rtol=0, atol=0)
    torch.testing.assert_close(stream_part, stream_all[emax * SP: 3 * emax * SP], rtol=0, atol=0)
    with pytest.raises(ValueError, match="outside the layout"):
        sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw, tiles=(2, 5))

    want = bwd.edge_attention_bwd_dkv(
        torch.cat([q, dsum], 1), kv, lt.snd_receivers, lt.snd_valid, lt.snd_ptr,
        lt.snd_slots, **kw).reshape(nt, SP, 2 * d)[:, :S]
    for budget in (None, 3 * emax * SP * 2 * d * 4):       # one chunk; 2 of 4 tiles each
        dq, dkv = sb.stream_backward(q, kv, dsum, *idx, **kw, chunk_bytes=budget)
        torch.testing.assert_close(dq, dq_all, rtol=0, atol=0)
        torch.testing.assert_close(dkv, want, rtol=1e-5, atol=1e-5)
    assert float(dkv[0].abs().max()) == 0.0                # node 0 never sends


@pytest.mark.parametrize("chunk_tiles", [None, 1])          # one chunk; one per tile
def test_pass_b_fixed_order_sum_matches_index_add(rng, monkeypatch, chunk_tiles):
    """Pass B through ``segment_sum_into``, the one fixed-order sum (the
    sorted ``index_put_`` on the card, held bit for bit there by the card
    tests; ``index_add_`` on the CPU), equals ``index_add_`` of the walked
    slots' rows by sender within 1e-6 relative, one call per chunk, on one
    chunk and on several; the rows of slots never walked hold NaN and add
    nothing."""
    d = 16
    _, gt = make_graphs(rng, n=29, e=90, n_pad=32, e_pad=128)
    lt = fmt.compute_layout(gt, tile_nodes=8, edges_per_tile=128, sender_layout=False)
    t, emax = lt.tile_senders.shape
    nt = t * 8
    q, kv, dsum = (torch.from_numpy(a) for a in
                   (rows(rng, nt, d), rows(rng, nt, 2 * d), rows(rng, nt, d, True)))
    idx = (lt.tile_senders, lt.tile_valid, lt.recv_ptr, lt.recv_slots)
    kw = dict(s=S, sp=SP, num_heads=H, softmax=True)
    _, stream = sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw)
    walked = sb.walked_slots(lt.tile_senders, lt.recv_ptr, (0, t))
    per_slot = stream.view(-1, SP, 2 * d)[:, :S]
    want = torch.zeros(nt, S, 2 * d).index_add_(
        0, lt.tile_senders.reshape(-1)[walked].long(), per_slot[walked])

    calls = []

    def counted(out, data, ids, mask=None):
        calls.append(data.shape[0])
        return segment_sum_into(out, data, ids, mask)

    monkeypatch.setattr(sb, "segment_sum_into", counted)
    budget = chunk_tiles and chunk_tiles * emax * SP * 2 * d * 4
    _, dkv = sb.stream_backward(q, kv, dsum, *idx, **kw, chunk_bytes=budget)
    assert calls == ([t * emax] if chunk_tiles is None else [emax] * t)
    torch.testing.assert_close(dkv, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    assert float(want.abs().max()) > 0.1

    nan_stream = stream.view(-1, SP, 2 * d).clone()
    nan_stream[~walked] = float("nan")
    got = sb.stream_to_senders(nan_stream.view_as(stream), lt.tile_senders, walked, 0,
                               torch.zeros(nt, S, 2 * d), s=S, sp=SP)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


# ------------------------------------------------------------------ the op's gradients


def make_params(rng, d):
    return [rng.normal(size=s).astype(np.float32) * sc
            for s, sc in (((d, 3 * d), 0.3), ((3 * d,), 0.1), ((d, d), 0.3), ((d,), 0.1))]


def torch_grads(x, p, fn):
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (x, *p)]
    out = fn(leaves[0], MHAParams(*leaves[1:]))
    (out * out.cos()).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def assert_grads_close(got, ref, what):
    for name, a, b in zip(NAMES, got, ref):
        np.testing.assert_allclose(
            a, b, rtol=2e-4, atol=2e-5 * max(1.0, float(np.abs(b).max())),
            err_msg=f"{name} vs {what}")


def fused_call(gt, lt, tmask, tn, softmax=True, gather="auto", with_snd=False, **kw):
    snd = {}
    if with_snd:
        snd = dict(snd_receivers=lt.snd_receivers, snd_valid=fmt.snd_slot_valid(lt, tmask),
                   snd_ptr=lt.snd_ptr, snd_slots=lt.snd_slots)

    def fn(xt, pt):
        return eaf.amp_edge_attention_fused(
            xt, pt, gt.receivers, tmask, lt.tile_senders,
            fmt.edge_slot_valid(lt, tmask), lt.recv_ptr, lt.recv_slots, H,
            softmax=softmax, tile_nodes=tn, gather=gather, **snd, **kw)
    return fn


@pytest.mark.parametrize("case,gather,softmax,d", [
    ("runtime_mask", "vmem", True, 16), ("runtime_mask", "dma", True, 16),
    ("structural", "dma", False, 16), ("uneven_tiles", "vmem", True, 16),
    ("scatterfree_off", "dma", True, 16), ("d100", "vmem", True, 100),
])
def test_stream_backward_gradients_match_jax_and_scatterfree(rng, monkeypatch, case,
                                                             gather, softmax, d):
    """dx and the four parameter gradients of the fused op through the
    stream backward (K1 forward, K5 + pass B through their plain versions)
    against jax.grad through the JAX op without ``snd_*`` in interpret mode
    (gather 'vmem': _bwd_kernel_vmem_v2 and one segment-sum; 'dma':
    _bwd_kernel_dma_compact and the chunked fold), against the port's
    scatter-free backward, and against autograd through the plain oracle.
    Cases: a runtime-scattered mask with structural trip counts, the
    structural mask alone, a node count (13) that leaves the last of four
    tiles ragged, ``scatterfree=False`` on a layout that HAS its sender
    side, and D=100 (no TPU lane rule). Every case has a receiver and a
    sender of degree 0."""
    monkeypatch.setattr(jeaf, "_auto_group", lambda sp, emax, gather: GROUP)
    n, tn = (13, 4) if case == "uneven_tiles" else (16, 8)
    gj, gt = make_graphs(rng, n=n, e=34, n_pad=n, e_pad=48)
    full = case == "scatterfree_off"
    lj = jfmt.compute_layout(gj, tile_nodes=tn, sender_layout=full)
    lt = fmt.compute_layout(gt, tile_nodes=tn, sender_layout=full)
    lsnd = fmt.compute_layout(gt, tile_nodes=tn)
    assert (lt.snd_ptr is None) == (not full)
    mask = runtime_mask(rng, gt) if case == "runtime_mask" else gt.edge_mask.numpy()
    x = rng.normal(size=(n, S, d)).astype(np.float32)
    p = make_params(rng, d)
    tmask = torch.from_numpy(mask)

    def jax_loss(xj, pj):
        snd = {}
        if full:
            snd = dict(snd_receivers=lj.snd_receivers, snd_local=lj.snd_local,
                       snd_valid=lj.snd_valid, snd_counts=lj.snd_counts,
                       snd_edge_slot=lj.snd_edge_slot, scatterfree=False)
        out = jeaf.amp_edge_attention_pallas(
            xj, pj, gj.senders, gj.receivers, jnp.asarray(mask),
            lj.tile_senders, lj.tile_recv,
            jax_scatter(lj.edge_slot, lj.tile_valid.shape, jnp.asarray(mask)),
            num_heads=H, softmax=softmax, tile_nodes=tn, gather=gather,
            fused_bwd=True, interpret=True, tile_counts=lj.tile_counts, **snd)
        return jnp.sum(out * jnp.cos(out))

    def oracle(xt, pt):
        return amp_edge_attention(xt, gt.senders, gt.receivers, tmask, pt, H,
                                  softmax=softmax)[0]

    launches = dict(eaf.launch_counts())
    out, got = torch_grads(x, p, fused_call(
        gt, lt, tmask, tn, softmax, gather, with_snd=full,
        **({"scatterfree": False} if full else {})))
    _, via_passes_r_s = torch_grads(x, p, fused_call(gt, lsnd, tmask, tn, softmax, gather,
                                                     with_snd=True))
    _, via_autograd = torch_grads(x, p, fused_call(gt, lt, tmask, tn, softmax, gather,
                                                   fused_bwd=False, senders=gt.senders))
    _, ref_oracle = torch_grads(x, p, oracle)
    gx, gp = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), JaxParams(*map(jnp.asarray, p)))
    assert_grads_close(got, [np.asarray(a) for a in (gx, *gp)], "jax.grad")
    assert_grads_close(got, via_passes_r_s, "the scatter-free backward")
    assert_grads_close(got, ref_oracle, "oracle autograd")
    assert_grads_close(via_autograd, ref_oracle, "fused_bwd=False vs oracle autograd")
    zero = np.bincount(gt.receivers.numpy()[mask], minlength=n) == 0
    assert zero[n - 1] and (out[zero] == 0.0).all()
    assert eaf.launch_counts() == launches               # CPU tensors: plain versions only


def test_backward_route_follows_layout_and_flags(rng, monkeypatch):
    """Which backward the op takes: passes R and S with a sender side, the
    stream backward without one or with scatterfree off (argument or
    AMPNET_SCATTERFREE_BWD's default), autograd of the plain op with
    fused_bwd=False; a forward without a gradient saves nothing."""
    _, gt = make_graphs(rng)
    lt = fmt.compute_layout(gt, tile_nodes=8)
    l0 = fmt.compute_layout(gt, tile_nodes=8, sender_layout=False)
    p = MHAParams(*map(torch.from_numpy, make_params(rng, 16)))
    called = []
    for mod, name in ((bwd, "edge_attention_bwd_dq"), (bwd, "edge_attention_bwd_dkv"),
                      (sb, "edge_attention_bwd_stream")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k: (
            called.append(_n), _o(*a, **k))[1])

    def run(layout, **kw):
        called.clear()
        x = torch.randn(16, S, 16, requires_grad=True)
        fused_call(gt, layout, gt.edge_mask, 8, with_snd=layout.snd_ptr is not None,
                   **kw)(x, p).sum().backward()
        return list(called)

    r_s = ["edge_attention_bwd_dq", "edge_attention_bwd_dkv"]
    assert run(lt) == r_s
    assert run(l0) == ["edge_attention_bwd_stream"]
    assert run(lt, scatterfree=False) == ["edge_attention_bwd_stream"]
    assert run(lt, fused_bwd=False, senders=gt.senders) == []
    monkeypatch.setattr(eaf, "SCATTERFREE_BWD_DEFAULT", False)
    assert run(lt) == ["edge_attention_bwd_stream"]
    assert run(lt, scatterfree=True) == r_s
    with pytest.raises(ValueError, match="needs the edge list's senders"):
        run(l0, fused_bwd=False)


def test_chunked_fold_equals_unchunked(rng, monkeypatch):
    """A stream budget that forces one chunk per tile (4 chunks) gives the
    unchunked gradients: chunk boundaries only change the order in which
    the per-node dK|dV sums are taken. The 'vmem' gather never chunks (the
    JAX package's rule)."""
    _, gt = make_graphs(rng, n=29, e=90, n_pad=32, e_pad=128)
    l0 = fmt.compute_layout(gt, tile_nodes=8, sender_layout=False)
    x = rng.normal(size=(32, S, 16)).astype(np.float32)
    p = make_params(rng, 16)
    tiles = []
    orig = sb.edge_attention_bwd_stream
    monkeypatch.setattr(sb, "edge_attention_bwd_stream",
                        lambda *a, **k: (tiles.append(k["tiles"]), orig(*a, **k))[1])

    def grads(gather):
        tiles.clear()
        return torch_grads(x, p, fused_call(gt, l0, gt.edge_mask, 8, gather=gather))[1]

    monkeypatch.setattr(sb, "_STREAM_CHUNK_BYTES", 1 << 62)
    whole = grads("dma")
    assert tiles == [(0, 4)]
    monkeypatch.setattr(sb, "_STREAM_CHUNK_BYTES", 4096)
    chunked = grads("dma")
    assert tiles == [(0, 1), (1, 2), (2, 3), (3, 4)]
    for name, a, b in zip(NAMES, chunked, whole):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7 * max(1.0, np.abs(b).max()),
                                   err_msg=name)
    grads("vmem")
    assert tiles == [(0, 4)]
