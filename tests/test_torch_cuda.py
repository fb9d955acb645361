"""The port's CUDA kernels on the card against their plain versions, and
the fused path (forward and gradients, through the scatter-free and the
stream backward) on the card against the plain torch path on the CPU.

Needs an NVIDIA GPU: every test is marked `cuda` and skips where
torch.cuda.is_available() is false. Imports no JAX, so that it runs on a
GPU machine without it:  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: rtol 2e-4 / atol 2e-5, as the parity tests on the CPU (f32;
the kernels sum in in-edge order, the plain versions after batched
matmuls)."""
import numpy as np
import pytest
import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.edge_attention import MHAParams, amp_edge_attention
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
from ampnet_tpu_torch.ops.hopper.format import (
    compute_layout,
    edge_slot_valid,
    snd_slot_valid,
)

RTOL, ATOL = 2e-4, 2e-5
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def graph(seed, n=40, e=160, f=12, first_sender=0):
    """Node n-1 is never a receiver (and no node below first_sender a
    sender); every 7th live edge is masked at run time."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, f)) < 0.4).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(first_sender, n, e), rng.integers(0, n - 1, e)])
    split = rng.random(n)
    g = from_arrays(x, ei, y=rng.integers(0, 3, n), train_mask=split < 0.5,
                    val_mask=split >= 0.5, pad_nodes_to=48, pad_edges_to=256)
    mask = g.edge_mask.clone()
    mask[torch.nonzero(mask)[::7, 0]] = False
    return g, mask


def params(seed, d):
    rng = np.random.default_rng(seed)
    return MHAParams(*(torch.from_numpy(rng.normal(size=s).astype(np.float32) * sc)
                       for s, sc in (((d, 3 * d), d ** -0.5), ((3 * d,), 0.1),
                                     ((d, d), d ** -0.5), ((d,), 0.1))))


SHAPES = [(4, 16, 2), (20, 128, 4), (40, 128, 4), (7, 100, 4)]


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,d,h", SHAPES)
def test_kernels_match_plain_on_card(cuda, s, d, h, softmax):
    g, mask = graph(0)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    valid = edge_slot_valid(lay, mask.to(cuda))
    idx = (lay.tile_senders, valid, lay.recv_ptr, lay.recv_slots)
    nt = lay.recv_ptr.numel() - 1
    sp = -(-s // 8) * 8
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=cuda)
    kw = dict(s=s, sp=sp, num_heads=h, softmax=softmax)
    before = eaf.edge_attention_sums.launches
    got = eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], *idx, **kw)
    ref = eaf.edge_attention_sums_plain(qkv[:, :d], qkv[:, d:], *idx, **kw)
    torch.cuda.synchronize()
    assert eaf.edge_attention_sums.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    assert (got.reshape(nt, sp, d)[39] == 0).all()       # degree 0: exact zeros

    w = [t.to(cuda) for t in params(2, d)]
    deg = torch.bincount(g.receivers[mask], minlength=nt).to(cuda, torch.float32)
    invdeg = torch.where(deg > 0, 1.0 / deg.clamp_min(1.0), torch.zeros_like(deg))
    x_rows = qkv[:, :d].contiguous()
    got = eaf.edge_attention_layer(x_rows, *w, invdeg, *idx, **kw)
    ref = eaf.edge_attention_layer_plain(x_rows, *w, invdeg, *idx, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    assert (got.reshape(nt, sp, d)[39] == 0).all()


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,d,h", SHAPES)
def test_backward_kernels_match_plain_on_card(cuda, s, d, h, softmax):
    """K3 (pass R) and K4 (pass S) against their plain versions, with a
    runtime mask, a receiver and a sender of degree 0, SP > S and D=100."""
    g, mask = graph(0, first_sender=1)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    nt = lay.recv_ptr.numel() - 1
    sp = -(-s // 8) * 8
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=cuda)
    qdm = torch.cat([qkv[:, :d], torch.randn(nt * sp, d, generator=gen, device=cuda)], 1)
    kw = dict(s=s, sp=sp, num_heads=h, softmax=softmax)
    before = eaf.launch_counts()

    r_idx = (lay.tile_senders, edge_slot_valid(lay, mask.to(cuda)), lay.recv_ptr, lay.recv_slots)
    got = bwd.edge_attention_bwd_dq(qkv[:, :d], qkv[:, d:], qdm[:, d:], *r_idx, **kw)
    ref = bwd.edge_attention_bwd_dq_plain(qkv[:, :d], qkv[:, d:], qdm[:, d:], *r_idx, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    assert (got.reshape(nt, sp, d)[39] == 0).all()       # receiver of degree 0
    assert (got.reshape(nt, sp, d)[:, s:] == 0).all()    # pad token rows

    s_idx = (lay.snd_receivers, snd_slot_valid(lay, mask.to(cuda)), lay.snd_ptr, lay.snd_slots)
    got = bwd.edge_attention_bwd_dkv(qdm, qkv[:, d:], *s_idx, **kw)
    ref = bwd.edge_attention_bwd_dkv_plain(qdm, qkv[:, d:], *s_idx, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    assert (got.reshape(nt, sp, 2 * d)[0] == 0).all()    # sender of degree 0
    assert (got.reshape(nt, sp, 2 * d)[:, s:] == 0).all()
    after = eaf.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "edge_attention_sums": 0, "edge_attention_layer": 0,
        "edge_attention_bwd_dq": 1, "edge_attention_bwd_dkv": 1,
        "edge_attention_bwd_stream": 0}
    # no atomics: a second launch repeats the first bit for bit
    assert torch.equal(got, bwd.edge_attention_bwd_dkv(qdm, qkv[:, d:], *s_idx, **kw))


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,d,h", SHAPES)
def test_stream_kernel_matches_plain_on_card(cuda, s, d, h, softmax):
    """K5 (pass A) against its plain version: the dQ rows, and the stream on
    the walked slots (rows of other slots are never written), with a runtime
    mask, a receiver of degree 0, SP > S and D=100; then a launch over a
    range of tiles, and pass B against K4 on the sender side."""
    g, mask = graph(0, first_sender=1)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    t, emax = lay.tile_senders.shape
    nt = lay.recv_ptr.numel() - 1
    sp = -(-s // 8) * 8
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=cuda)
    qdm = torch.cat([qkv[:, :d], torch.randn(nt * sp, d, generator=gen, device=cuda)], 1)
    q, kv, dsum = qkv[:, :d], qkv[:, d:], qdm[:, d:]
    kw = dict(s=s, sp=sp, num_heads=h, softmax=softmax)
    valid = edge_slot_valid(lay, mask.to(cuda))
    idx = (lay.tile_senders, valid, lay.recv_ptr, lay.recv_slots)
    before = eaf.launch_counts()
    dq, stream = sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw)
    dq_ref, stream_ref = sb.edge_attention_bwd_stream_plain(q, kv, dsum, *idx, **kw)
    torch.cuda.synchronize()
    after = eaf.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "edge_attention_bwd_stream": 1}
    torch.testing.assert_close(dq, dq_ref, rtol=RTOL, atol=ATOL)
    assert (dq.reshape(nt, sp, d)[39] == 0).all()         # receiver of degree 0
    assert (dq.reshape(nt, sp, d)[:, s:] == 0).all()      # pad token rows
    slots = lay.recv_slots.long()
    got = stream.view(t * emax, sp, 2 * d)[slots]
    torch.testing.assert_close(got, stream_ref.view(t * emax, sp, 2 * d)[slots],
                               rtol=RTOL, atol=ATOL)
    assert (got[:, s:] == 0).all()
    dropped = valid.reshape(-1)[slots] == 0
    assert dropped.any() and (got[dropped] == 0).all()    # walked, weighted 0
    # the dQ sums are taken in slot order: a second launch repeats them
    assert torch.equal(dq, sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw)[0])

    dq_part, stream_part = sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw, tiles=(1, 3))
    torch.cuda.synchronize()
    assert torch.equal(dq_part, dq[16 * sp: 48 * sp])
    in_range = (slots >= emax) & (slots < 3 * emax)
    assert torch.equal(stream_part.view(2 * emax, sp, 2 * d)[slots[in_range] - emax],
                       got[in_range])

    s_idx = (lay.snd_receivers, snd_slot_valid(lay, mask.to(cuda)), lay.snd_ptr, lay.snd_slots)
    want = bwd.edge_attention_bwd_dkv(qdm, kv, *s_idx, **kw).reshape(nt, sp, 2 * d)[:, :s]
    for budget in (None, 2 * emax * sp * 2 * d * 4):      # one chunk; 2 then 1 tiles
        dq_f, dkv = sb.stream_backward(q, kv, dsum, *idx, **kw, chunk_bytes=budget)
        torch.cuda.synchronize()
        assert torch.equal(dq_f, dq)
        torch.testing.assert_close(dkv, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s,d,h,gather", [(20, 128, 4, "vmem"), (40, 128, 4, "dma"),
                                          (7, 100, 4, "auto")])
def test_fused_op_gradients_on_card_match_plain_cpu(cuda, s, d, h, gather):
    """The five gradients of the fused op on the card (K1 forward, K3 + K4
    backward, whatever the dispatch says) against autograd through the
    plain oracle on the CPU; D=100 has no TPU lane limit here."""
    g, mask = graph(3, first_sender=1)
    p = params(4, d)
    x = torch.randn(48, s, d, generator=torch.Generator().manual_seed(5))
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    leaves = [t.to(cuda).requires_grad_() for t in (x, *p)]
    eaf.reset_launch_counts()
    out = eaf.amp_edge_attention_fused(
        leaves[0], MHAParams(*leaves[1:]), g.receivers.to(cuda), mask.to(cuda),
        lay.tile_senders, edge_slot_valid(lay, mask.to(cuda)), lay.recv_ptr,
        lay.recv_slots, h, tile_nodes=16, gather=gather,
        snd_receivers=lay.snd_receivers, snd_valid=snd_slot_valid(lay, mask.to(cuda)),
        snd_ptr=lay.snd_ptr, snd_slots=lay.snd_slots)
    (out * out.cos()).sum().backward()
    assert eaf.launch_counts() == {
        "edge_attention_sums": 1, "edge_attention_layer": 0,
        "edge_attention_bwd_dq": 1, "edge_attention_bwd_dkv": 1,
        "edge_attention_bwd_stream": 0}
    cpu = [t.clone().requires_grad_() for t in (x, *p)]
    ref, _ = amp_edge_attention(cpu[0], g.senders, g.receivers, mask,
                                MHAParams(*cpu[1:]), h)
    (ref * ref.cos()).sum().backward()
    for name, a, b in zip(("x", "w_qkv", "b_qkv", "w_out", "b_out"), leaves, cpu):
        # f32 sums over 48 nodes x S tokens in another order: scaled by the
        # gradient's largest entry
        scale = float(b.grad.abs().max())
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=RTOL,
                                   atol=1e-5 * max(scale, 1.0), msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("gather,kernel", [("dma", "edge_attention_sums"),
                                           ("vmem", "edge_attention_layer")])
def test_fused_op_on_card_matches_plain_cpu(cuda, gather, kernel):
    g, mask = graph(3)
    d, h, s = 128, 4, 20
    p = params(4, d)
    x = torch.randn(48, s, d, generator=torch.Generator().manual_seed(5))
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    eaf.reset_launch_counts()
    got = eaf.amp_edge_attention_fused(
        x.to(cuda), MHAParams(*(t.to(cuda) for t in p)), g.receivers.to(cuda),
        mask.to(cuda), lay.tile_senders, edge_slot_valid(lay, mask.to(cuda)),
        lay.recv_ptr, lay.recv_slots, h, tile_nodes=16, gather=gather)
    assert eaf.launch_counts()[kernel] == 1 and sum(eaf.launch_counts().values()) == 1
    ref, _ = amp_edge_attention(x, g.senders, g.receivers, mask, p, h)
    torch.testing.assert_close(got.cpu(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s,d,h,gather,chunks", [
    (20, 128, 4, "vmem", 1), (40, 128, 4, "dma", 1), (20, 128, 4, "dma", 3),
    (7, 100, 4, "auto", 1)])
def test_fused_op_stream_gradients_on_card_match_plain_cpu(cuda, monkeypatch, s, d, h,
                                                           gather, chunks):
    """The five gradients on a layout WITHOUT a sender side (K1 forward, K5 +
    pass B backward, one launch per tile chunk) against autograd through the
    plain oracle on the CPU, and against the scatter-free backward on the
    card."""
    g, mask = graph(3, first_sender=1)
    p = params(4, d)
    x = torch.randn(48, s, d, generator=torch.Generator().manual_seed(5))
    lay = compute_layout(g, tile_nodes=16, sender_layout=False).to(cuda)
    full = compute_layout(g, tile_nodes=16).to(cuda)
    t, emax = lay.tile_senders.shape
    sp = -(-s // 8) * 8
    if chunks > 1:                                        # one tile per chunk
        monkeypatch.setattr(sb, "_STREAM_CHUNK_BYTES", emax * sp * 2 * d * 4)

    def grads(layout, snd):
        leaves = [t.to(cuda).requires_grad_() for t in (x, *p)]
        eaf.reset_launch_counts()
        out = eaf.amp_edge_attention_fused(
            leaves[0], MHAParams(*leaves[1:]), g.receivers.to(cuda), mask.to(cuda),
            layout.tile_senders, edge_slot_valid(layout, mask.to(cuda)), layout.recv_ptr,
            layout.recv_slots, h, tile_nodes=16, gather=gather, **snd)
        (out * out.cos()).sum().backward()
        return [t.grad.cpu() for t in leaves], eaf.launch_counts()

    got, counts = grads(lay, {})
    assert counts == {
        "edge_attention_sums": 1, "edge_attention_layer": 0, "edge_attention_bwd_dq": 0,
        "edge_attention_bwd_dkv": 0, "edge_attention_bwd_stream": t if chunks > 1 else 1}
    via_r_s, _ = grads(full, dict(
        snd_receivers=full.snd_receivers, snd_valid=snd_slot_valid(full, mask.to(cuda)),
        snd_ptr=full.snd_ptr, snd_slots=full.snd_slots))
    cpu = [t.clone().requires_grad_() for t in (x, *p)]
    ref, _ = amp_edge_attention(cpu[0], g.senders, g.receivers, mask,
                                MHAParams(*cpu[1:]), h)
    (ref * ref.cos()).sum().backward()
    for name, a, r, b in zip(("x", "w_qkv", "b_qkv", "w_out", "b_out"), got, via_r_s, cpu):
        scale = float(b.grad.abs().max())
        for what, want in (("plain CPU", b.grad), ("scatter-free", r)):
            torch.testing.assert_close(a, want, rtol=RTOL, atol=1e-5 * max(scale, 1.0),
                                       msg=lambda m: f"{name} vs {what}: {m}")


def test_backward_kernels_refuse_a_shape_beyond_shared_memory(cuda):
    """No silent fallback: a backward kernel at a shape whose shared memory
    does not fit raises before it launches."""
    g, mask = graph(3)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    nt = lay.recv_ptr.numel() - 1
    big = torch.zeros(nt * 96, 4 * 128, device=cuda)
    r_idx = (lay.tile_senders, lay.tile_valid, lay.recv_ptr, lay.recv_slots)
    kw = dict(s=96, sp=96, num_heads=4, softmax=True)
    with pytest.raises(ValueError, match="shared memory"):
        bwd.edge_attention_bwd_dq(big[:, :128], big[:, 128:384], big[:, 384:], *r_idx, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        bwd.edge_attention_bwd_dkv(big[:, :256], big[:, 256:], lay.snd_receivers,
                                   lay.snd_valid, lay.snd_ptr, lay.snd_slots, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        sb.edge_attention_bwd_stream(big[:, :128], big[:, 128:384], big[:, 384:],
                                     *r_idx, **kw)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    g, _ = graph(0)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    nt = lay.recv_ptr.numel() - 1
    q = torch.zeros(nt * 8, 48, device=cuda)
    kw = dict(s=4, sp=8, num_heads=2, softmax=True)
    with pytest.raises(ValueError, match="int32"):
        eaf.edge_attention_sums(q[:, :16], q[:, 16:], lay.tile_senders.long(),
                                lay.tile_valid, lay.recv_ptr, lay.recv_slots, **kw)
    with pytest.raises(ValueError, match="float32"):
        eaf.edge_attention_sums(q[:, :16].double(), q[:, 16:], lay.tile_senders,
                                lay.tile_valid, lay.recv_ptr, lay.recv_slots, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(nt * 200, 3 * 128, device=cuda)
        eaf.edge_attention_sums(big[:, :128], big[:, 128:], lay.tile_senders,
                                lay.tile_valid, lay.recv_ptr, lay.recv_slots,
                                s=200, sp=200, num_heads=4, softmax=True)


@pytest.mark.parametrize("s", [20, 40])
def test_ampgcn_on_card_matches_cpu(cuda, s):
    g, _ = graph(6)
    cfg = AMPGCNConfig(embedding_dim=128, num_heads=4, num_node_features=12,
                       num_sampled_vectors=s, output_dim=3, raw_residual="gcn2",
                       use_pallas=True)
    model = AMPGCN(cfg, device=cuda)
    idx = torch.randint(0, 12, (48, s), generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        got = model(g.to(cuda), sampled_idx=idx.to(cuda),
                    edge_layout=compute_layout(g.to(cuda), tile_nodes=16)).cpu()
        ref = model.to("cpu")(g, sampled_idx=idx, edge_layout=compute_layout(g, tile_nodes=16))
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
