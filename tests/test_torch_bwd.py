"""The port's scatter-free backward against the JAX package: the plain
versions of K3 / K4 against the Pallas passes R and S in interpret mode
(both gathers, softmax on and off), and the fused op's five gradients
against jax.grad through ``amp_edge_attention_pallas`` and against
torch.autograd through the port's plain oracle.

Sizes: 13-16 nodes, S=4 (row stride SP=8 > S), D=16, H=2, tile_nodes 4-8.
Tolerances: the passes alone rtol/atol 1e-5 (f32, the same per-edge math,
sums in another order); the op's gradients rtol 2e-4 with atol 2e-5 times
the gradient's largest entry (they pass through two projections and a
cos-weighted cotangent of size ~100)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
from ampnet_tpu.ops.edge_attention import MHAParams as JaxParams
from ampnet_tpu.ops.pallas import edge_attention_bwd_scatterfree as jbwd
from ampnet_tpu.ops.pallas import edge_attention_fused as jeaf
from ampnet_tpu.ops.pallas import format as jfmt
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.ops.edge_attention import MHAParams, amp_edge_attention
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
from ampnet_tpu_torch.ops.hopper import format as fmt

S, SP, D, H = 4, 8, 16, 2
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


# ------------------------------------------------------------------ layout


def test_sender_index_walks_every_live_slot_once(rng):
    _, gt = make_graphs(rng)
    lt = fmt.compute_layout(gt, tile_nodes=8)
    ptr, slots = lt.snd_ptr.numpy(), lt.snd_slots.numpy()
    emax = lt.snd_receivers.shape[1]
    t_of, pos = slots // emax, slots % emax
    assert ptr.dtype == slots.dtype == np.int32
    assert ptr[0] == 0 and ptr[-1] == len(slots) == int(lt.snd_counts.sum())
    assert len(set(slots.tolist())) == len(slots)
    snd_of_slot = t_of * 8 + lt.snd_local.numpy()[t_of, pos]
    np.testing.assert_array_equal(snd_of_slot, np.repeat(np.arange(len(ptr) - 1), np.diff(ptr)))
    assert ptr[1] == 0                                  # node 0 never sends
    rcv = lt.snd_receivers.numpy().reshape(-1)[slots]
    m = gt.edge_mask.numpy()
    assert sorted(zip(snd_of_slot, rcv)) == sorted(
        zip(gt.senders.numpy()[m], gt.receivers.numpy()[m]))
    assert fmt.compute_layout(gt, tile_nodes=8, sender_layout=False).snd_ptr is None


def test_sender_runtime_mask_scatter_matches_jax(rng):
    """The mirror of edge_slot_valid on the sender side, against the scatter
    the JAX op does itself (edge_attention_fused.py:2021-2029)."""
    gj, gt = make_graphs(rng)
    lj = jfmt.compute_layout(gj, tile_nodes=8)
    lt = fmt.compute_layout(gt, tile_nodes=8)
    mask = runtime_mask(rng, gt)
    got = fmt.snd_slot_valid(lt, torch.from_numpy(mask))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_scatter(lj.snd_edge_slot, lj.snd_valid.shape,
                                            jnp.asarray(mask))))
    assert int(got.sum()) == int(mask.sum()) == int(
        fmt.edge_slot_valid(lt, torch.from_numpy(mask)).sum())


# ------------------------------------------------------------------ passes R and S


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("gather", ["vmem", "dma"])
def test_bwd_dq_plain_matches_pallas_pass_r(rng, gather, softmax):
    """K3's plain version against _dq_kernel_vmem / _dq_kernel_dma."""
    gj, gt = make_graphs(rng)
    lj = jfmt.compute_layout(gj, tile_nodes=8)
    lt = fmt.compute_layout(gt, tile_nodes=8)
    t, emax = lj.tile_senders.shape
    nt = t * 8
    q, kv, dsum = rows(rng, nt, D), rows(rng, nt, 2 * D), rows(rng, nt, D, True)
    mask = runtime_mask(rng, gt)
    vj = jax_scatter(lj.edge_slot, lj.tile_valid.shape, jnp.asarray(mask))
    ref = jbwd.fused_edge_bwd_dq(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(dsum),
        lj.tile_senders[:, None, :], lj.tile_recv[:, None, :], vj[:, None, :],
        lj.tile_counts, num_heads=H, softmax=softmax, tile_nodes=8,
        group=GROUP, num_tiles=t, emax=emax, s=S,
        gather=gather, interpret=True)
    got = bwd.edge_attention_bwd_dq(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(dsum),
        lt.tile_senders, fmt.edge_slot_valid(lt, torch.from_numpy(mask)),
        lt.recv_ptr, lt.recv_slots, s=S, sp=SP, num_heads=H, softmax=softmax)
    got = got.numpy().reshape(nt, SP, D)
    np.testing.assert_allclose(got[:, :S], np.asarray(ref).reshape(nt, SP, D)[:, :S],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[:, S:], 0.0)
    np.testing.assert_array_equal(got[15], 0.0)         # receiver of degree 0
    assert np.abs(got).max() > 0.1


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("gather", ["vmem", "dma"])
def test_bwd_dkv_plain_matches_pallas_pass_s(rng, gather, softmax):
    """K4's plain version against _dkv_kernel_vmem / _dkv_kernel_dma."""
    gj, gt = make_graphs(rng)
    lj = jfmt.compute_layout(gj, tile_nodes=8)
    lt = fmt.compute_layout(gt, tile_nodes=8)
    t, emax = lj.snd_receivers.shape
    nt = t * 8
    qdm = np.concatenate([rows(rng, nt, D), rows(rng, nt, D, True)], axis=1)
    kv = rows(rng, nt, 2 * D)
    mask = runtime_mask(rng, gt)
    vj = jax_scatter(lj.snd_edge_slot, lj.snd_valid.shape, jnp.asarray(mask))
    ref = jbwd.fused_edge_bwd_dkv(
        jnp.asarray(qdm), jnp.asarray(kv), lj.snd_receivers[:, None, :],
        lj.snd_local[:, None, :], vj[:, None, :], lj.snd_counts,
        num_heads=H, softmax=softmax, tile_nodes=8,
        group=GROUP, num_tiles=t, emax=emax, s=S,
        gather=gather, interpret=True)
    got = bwd.edge_attention_bwd_dkv(
        torch.from_numpy(qdm), torch.from_numpy(kv), lt.snd_receivers,
        fmt.snd_slot_valid(lt, torch.from_numpy(mask)), lt.snd_ptr, lt.snd_slots,
        s=S, sp=SP, num_heads=H, softmax=softmax)
    got = got.numpy().reshape(nt, SP, 2 * D)
    np.testing.assert_allclose(got[:, :S], np.asarray(ref).reshape(nt, SP, 2 * D)[:, :S],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[:, S:], 0.0)
    np.testing.assert_array_equal(got[0], 0.0)          # sender of degree 0
    assert np.abs(got).max() > 0.1


# ------------------------------------------------------------------ the op's gradients


def make_params(rng):
    p = [rng.normal(size=s).astype(np.float32) * sc
         for s, sc in (((D, 3 * D), 0.3), ((3 * D,), 0.1), ((D, D), 0.3), ((D,), 0.1))]
    return p


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


@pytest.mark.parametrize("case,gather,softmax", [
    ("runtime_mask", "vmem", True), ("runtime_mask", "dma", True),
    ("structural", "dma", False), ("uneven_tiles", "vmem", True),
])
def test_fused_op_gradients_match_jax_and_oracle(rng, monkeypatch, case, gather, softmax):
    """dx and the four parameter gradients of the fused op (K1 forward, K3 +
    K4 backward through their plain versions) against jax.grad through the
    JAX op with its scatter-free backward in interpret mode, and against
    autograd through the port's plain oracle. Cases: a runtime-scattered
    mask, the structural mask alone, and a node count (13) that leaves the
    last of four tiles ragged; every case has receivers of degree 0."""
    monkeypatch.setattr(jeaf, "_auto_group", lambda sp, emax, gather: GROUP)
    n, tn = (13, 4) if case == "uneven_tiles" else (16, 8)
    gj, gt = make_graphs(rng, n=n, e=34, n_pad=n, e_pad=48)
    lj = jfmt.compute_layout(gj, tile_nodes=tn)
    lt = fmt.compute_layout(gt, tile_nodes=tn)
    mask = runtime_mask(rng, gt) if case == "runtime_mask" else gt.edge_mask.numpy()
    x = rng.normal(size=(n, S, D)).astype(np.float32)
    p = make_params(rng)
    tmask = torch.from_numpy(mask)

    def fused(xt, pt):
        return eaf.amp_edge_attention_fused(
            xt, pt, gt.receivers, tmask, lt.tile_senders,
            fmt.edge_slot_valid(lt, tmask), lt.recv_ptr, lt.recv_slots, H,
            softmax=softmax, tile_nodes=tn, gather=gather,
            snd_receivers=lt.snd_receivers, snd_valid=fmt.snd_slot_valid(lt, tmask),
            snd_ptr=lt.snd_ptr, snd_slots=lt.snd_slots)

    def oracle(xt, pt):
        return amp_edge_attention(xt, gt.senders, gt.receivers, tmask, pt, H,
                                  softmax=softmax)[0]

    def jax_loss(xj, pj):
        out = jeaf.amp_edge_attention_pallas(
            xj, pj, gj.senders, gj.receivers, jnp.asarray(mask),
            lj.tile_senders, lj.tile_recv,
            jax_scatter(lj.edge_slot, lj.tile_valid.shape, jnp.asarray(mask)),
            num_heads=H, softmax=softmax, tile_nodes=tn, gather=gather,
            fused_bwd=True, interpret=True, tile_counts=lj.tile_counts,
            snd_receivers=lj.snd_receivers, snd_local=lj.snd_local,
            snd_valid=lj.snd_valid, snd_counts=lj.snd_counts,
            snd_edge_slot=lj.snd_edge_slot, scatterfree=True)
        return jnp.sum(out * jnp.cos(out))

    out, got = torch_grads(x, p, fused)
    _, ref_oracle = torch_grads(x, p, oracle)
    gx, gp = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), JaxParams(*map(jnp.asarray, p)))
    assert_grads_close(got, [np.asarray(a) for a in (gx, *gp)], "jax.grad")
    assert_grads_close(got, ref_oracle, "oracle autograd")
    zero = np.bincount(gt.receivers.numpy()[mask], minlength=n) == 0
    assert zero[n - 1] and (out[zero] == 0.0).all()


def test_training_forward_is_sums_kernel_and_eval_is_layer_kernel(monkeypatch):
    """The JAX rule at the S=20 Cora shape (vmem gather, v6 usable): a
    forward that needs no gradient runs K2, a forward autograd will
    differentiate runs K1 plus glue (the whole-layer kernel keeps no sums
    for the backward), and so does a no-grad forward at S=40 (dma)."""
    calls = []
    for name in ("edge_attention_sums", "edge_attention_layer"):
        def fake(rows, *a, _name=name, **k):
            calls.append(_name)
            return rows.new_zeros(rows.shape[0], 128)
        monkeypatch.setattr(eaf, name, fake)
    n, nt, tn = 2752, 11 * 256, 256
    lay = dict(receivers=torch.zeros(4, dtype=torch.long), edge_mask=None,
               tile_senders=torch.zeros(11, 128, dtype=torch.int32),
               tile_valid=torch.zeros(11, 128, dtype=torch.int32),
               recv_ptr=torch.zeros(nt + 1, dtype=torch.int32),
               recv_slots=torch.zeros(0, dtype=torch.int32))
    p = MHAParams(torch.zeros(128, 384), torch.zeros(384), torch.zeros(128, 128),
                  torch.zeros(128))
    for s, grad, want in ((20, False, "edge_attention_layer"),
                          (20, True, "edge_attention_sums"),
                          (40, False, "edge_attention_sums")):
        calls.clear()
        x = torch.zeros(n, s, 128, requires_grad=grad)
        out = eaf.amp_edge_attention_fused(x, p, num_heads=4, tile_nodes=tn, **lay)
        assert calls == [want], (s, grad)
        assert out.requires_grad == grad
    # parameters that require a gradient count too, and no_grad overrides both
    pg = MHAParams(*(t.clone().requires_grad_() for t in p))
    calls.clear()
    eaf.amp_edge_attention_fused(torch.zeros(n, 20, 128), pg, num_heads=4, tile_nodes=tn, **lay)
    with torch.no_grad():
        eaf.amp_edge_attention_fused(torch.zeros(n, 20, 128), pg, num_heads=4, tile_nodes=tn, **lay)
    assert calls == ["edge_attention_sums", "edge_attention_layer"]


def test_fused_op_rejects_a_partial_or_mismatched_sender_side(rng):
    _, gt = make_graphs(rng)
    lt = fmt.compute_layout(gt, tile_nodes=8)
    other = fmt.compute_layout(gt, tile_nodes=4)
    p = MHAParams(*map(torch.from_numpy, make_params(rng)))
    args = (torch.zeros(16, S, D), p, gt.receivers, gt.edge_mask, lt.tile_senders,
            lt.tile_valid, lt.recv_ptr, lt.recv_slots, H)
    with pytest.raises(ValueError, match="all of snd_receivers"):
        eaf.amp_edge_attention_fused(*args, tile_nodes=8, snd_ptr=lt.snd_ptr)
    with pytest.raises(ValueError, match="sender layout has 4 tiles"):
        eaf.amp_edge_attention_fused(
            *args, tile_nodes=8, snd_receivers=other.snd_receivers,
            snd_valid=other.snd_valid, snd_ptr=other.snd_ptr, snd_slots=other.snd_slots)
