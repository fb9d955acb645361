"""The port's CUDA kernels on the card against their plain versions, the
fused path (forward and gradients, through the scatter-free and the
stream backward) on the card against the plain torch path on the CPU, and
the steps captured as CUDA graphs against their eager bodies.

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
from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav
from ampnet_tpu_torch.ops.hopper import launch
from ampnet_tpu_torch.ops.hopper.format import (
    chunk_slot_valid,
    compute_chunked_layout,
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
# the kernels with two bodies that walk nodes (K6, K7 and K9 walk slots)
K1_TO_K4 = ("edge_attention_sums", "edge_attention_layer", "edge_attention_bwd_dq",
            "edge_attention_bwd_dkv")


def launched(**counts):
    """launch_counts() with every wrapper at 0 but the named ones."""
    return {**dict.fromkeys(eaf.launch_counts(), 0), **counts}


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
    """K3 (pass R) and K4 (pass S, on the tensor cores) against their plain
    versions, with a runtime mask, a receiver and a sender of degree 0, SP >
    S and D=100."""
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
    assert {k: after[k] - before[k] for k in after} == launched(
        edge_attention_bwd_dq=1, edge_attention_bwd_dkv=1)
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


def test_stream_backward_holds_one_chunk_live(cuda):
    """24 chunks of one tile each, on a layout of a fixed budget: the peak
    memory beyond the inputs stays the outputs plus a few chunks' streams
    (pass B takes one chunk's slots, never the graph's), and the folded
    sums equal the one-launch ones."""
    rng = np.random.default_rng(3)
    n, e, f = 16 * 24, 6000, 12
    x = (rng.random((n, f)) < 0.4).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    g = from_arrays(x, rng.integers(0, n, (2, e)), y=rng.integers(0, 3, n),
                    train_mask=np.ones(n, bool), val_mask=np.ones(n, bool),
                    pad_nodes_to=n, pad_edges_to=e)
    lay = compute_layout(g, tile_nodes=16, edges_per_tile=512, sender_layout=False).to(cuda)
    t, emax = lay.tile_senders.shape
    s, d, h, sp = 20, 128, 4, 24
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, dsum = (torch.randn(n * sp, d, generator=gen, device=cuda) for _ in range(2))
    kv = torch.randn(n * sp, 2 * d, generator=gen, device=cuda)
    kw = dict(s=s, sp=sp, num_heads=h, softmax=True)
    idx = (lay.tile_senders, lay.tile_valid, lay.recv_ptr, lay.recv_slots)
    chunk = emax * sp * 2 * d * 4
    dq_1, dkv_1 = sb.stream_backward(q, kv, dsum, *idx, **kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = sb.edge_attention_bwd_stream.launches
    dq, dkv = sb.stream_backward(q, kv, dsum, *idx, **kw, chunk_bytes=chunk)
    torch.cuda.synchronize()
    assert t == 24 and sb.edge_attention_bwd_stream.launches - before == t
    peak = torch.cuda.max_memory_allocated() - base
    limit = 2 * dq.numel() * 4 + dkv.numel() * 4 + 3 * chunk + (1 << 20)
    assert peak <= limit < t * chunk // 2, (peak, limit, t * chunk)
    assert torch.equal(dq, dq_1)
    torch.testing.assert_close(dkv, dkv_1, rtol=RTOL, atol=ATOL)


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
    assert eaf.launch_counts() == launched(
        edge_attention_sums=1, edge_attention_bwd_dq=1, edge_attention_bwd_dkv=1)
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
    assert counts == launched(edge_attention_sums=1,
                              edge_attention_bwd_stream=t if chunks > 1 else 1)
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


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,d,h", [(96, 128, 4), (65, 128, 4), (20, 1024, 1)])
def test_cuda_core_bodies_beyond_shared_memory_match_plain(cuda, s, d, h, softmax):
    """Where a CUDA-core body's working set exceeds a block's shared memory
    (launch.simt_work_blocks > 0), K1-K5 keep it in device memory and agree
    with their plain versions; each launch counts under the CUDA-core body."""
    g, mask = graph(3, first_sender=1)
    lay, nt, sp, qkv, qdm, r_idx, s_idx, kw = tc_inputs(cuda, g, mask, s, d, h, softmax)
    q, kv, dsum = qkv[:, :d], qkv[:, d:], qdm[:, d:]
    w, invdeg = layer_inputs(cuda, g, mask, nt, d)
    x_rows = q.contiguous()
    eaf.reset_launch_counts()
    runs = {
        "edge_attention_sums": (lambda: eaf.edge_attention_sums(q, kv, *r_idx, **kw),
                                lambda: eaf.edge_attention_sums_plain(q, kv, *r_idx, **kw)),
        "edge_attention_layer": (
            lambda: eaf.edge_attention_layer(x_rows, *w, invdeg, *r_idx, **kw),
            lambda: eaf.edge_attention_layer_plain(x_rows, *w, invdeg, *r_idx, **kw)),
        "edge_attention_bwd_dq": (
            lambda: bwd.edge_attention_bwd_dq(q, kv, dsum, *r_idx, **kw),
            lambda: bwd.edge_attention_bwd_dq_plain(q, kv, dsum, *r_idx, **kw)),
        "edge_attention_bwd_dkv": (
            lambda: bwd.edge_attention_bwd_dkv(qdm, kv, *s_idx, **kw),
            lambda: bwd.edge_attention_bwd_dkv_plain(qdm, kv, *s_idx, **kw)),
        "edge_attention_bwd_stream": (
            lambda: sb.edge_attention_bwd_stream(q, kv, dsum, *r_idx, **kw)[0],
            lambda: sb.edge_attention_bwd_stream_plain(q, kv, dsum, *r_idx, **kw)[0]),
    }
    in_device_memory = set()
    for name, (run, plain) in runs.items():
        if launch.simt_work_blocks(name, s, d, h, nt, 132) > 0:
            in_device_memory.add(name)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL * max(1.0, float(ref.abs().max())),
                                   msg=lambda m: f"{name}: {m}")
        assert torch.equal(got, run())
    assert in_device_memory
    assert set(eaf.device_memory_launch_counts()) == in_device_memory
    bodies = eaf.body_launch_counts()
    assert all(bodies[k] == dict(tc=0, simt=2, tc_bf16=0, simt_bf16=0) for k in K1_TO_K4), bodies


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
    with pytest.raises(ValueError, match="range"):
        big = torch.zeros(nt * 200, 3 * 128, device=cuda)
        eaf.edge_attention_sums(big[:, :128], big[:, 128:], lay.tile_senders,
                                lay.tile_valid, lay.recv_ptr, lay.recv_slots,
                                s=200, sp=200, num_heads=4, softmax=True, body="tc")
    with pytest.raises(ValueError, match="multiple of num_heads"):
        eaf.edge_attention_sums(q[:, :15], q[:, 15:45], lay.tile_senders, lay.tile_valid,
                                lay.recv_ptr, lay.recv_slots, **kw)


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,d,h", SHAPES)
def test_variant_sums_match_plain_and_k1_on_card(cuda, s, d, h, softmax):
    """K6, K8 and K9 against their plain versions and against K1's sums, with
    a runtime mask, a receiver of degree 0, SP > S and D=100. K6 and K9 on
    both bodies (tensor cores and CUDA cores); K6 at its default group and
    at group 3 (receivers span groups; 128 slots leave a ragged last group);
    K9 under both gather names; K8 at chunks of 3 edges (partial and
    multi-chunk receivers: in-degrees reach 8) on both bodies, the CUDA
    cores' also in pieces of 2. K8 repeats bit for bit; K6 and K9 sum
    through atomics and are held to the tolerance only."""
    g, mask = graph(0)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    valid = edge_slot_valid(lay, mask.to(cuda))
    nt = lay.recv_ptr.numel() - 1
    sp = -(-s // 8) * 8
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=cuda)
    q, kv = qkv[:, :d], qkv[:, d:]
    kw = dict(s=s, sp=sp, num_heads=h, softmax=softmax)
    k1 = eaf.edge_attention_sums(q, kv, lay.tile_senders, valid, lay.recv_ptr,
                                 lay.recv_slots, **kw)
    slots = (lay.tile_senders, lay.tile_recv, valid)
    before = eaf.launch_counts()

    def check(got, ref):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got, k1, rtol=RTOL, atol=ATOL)
        assert (got.reshape(nt, sp, d)[39] == 0).all()     # degree 0: exact zeros
        assert (got.reshape(nt, sp, d)[:, s:] == 0).all()  # pad token rows

    bodies = eaf.body_launch_counts()
    for body in ("tc", "simt"):
        for group in (None, 3):
            check(eav.edge_attention_sums_mm(q, kv, *slots, lay.tile_counts, **kw,
                                             tile_nodes=16, group=group, body=body),
                  eav.edge_attention_sums_mm_plain(q, kv, *slots, lay.tile_counts, **kw,
                                                   tile_nodes=16, group=group or eav.MM_GROUP))
        for gather in ("dma", "vmem"):
            check(eav.edge_attention_sums_v1(q, kv, *slots, **kw, tile_nodes=16, group=8,
                                             gather=gather, body=body),
                  eav.edge_attention_sums_v1_plain(q, kv, *slots, **kw, tile_nodes=16, group=8))
    for k in ("edge_attention_sums_mm", "edge_attention_sums_v1"):
        assert eaf.body_launch_counts()[k] == dict(tc=bodies[k]["tc"] + 2,
                                                   simt=bodies[k]["simt"] + 2, tc_bf16=0,
                                                   simt_bf16=0)
    ck = compute_chunked_layout(g, tile_nodes=16, chunk_edges=3).to(cuda)
    assert int(ck.chunk_count.max()) >= 2
    chunks = (ck.senders, chunk_slot_valid(ck, mask.to(cuda)), ck.chunk_start,
              ck.chunk_count)
    ref = eav.edge_attention_sums_chunked_plain(q, kv, *chunks, **kw, chunk=3)
    k8_bodies = eaf.body_launch_counts()["edge_attention_sums_chunked"]
    for body in ("tc", "simt"):
        whole = eav.edge_attention_sums_chunked(q, kv, *chunks, **kw, chunk=3, body=body)
        check(whole, ref)
        assert torch.equal(whole, eav.edge_attention_sums_chunked(q, kv, *chunks, **kw,
                                                                  chunk=3, body=body))
    check(eav.edge_attention_sums_chunked(q, kv, *chunks, **kw, chunk=3, piece=2,
                                          body="simt"), ref)
    after = eaf.launch_counts()
    assert {k: after[k] - before[k] for k in after} == launched(
        edge_attention_sums_mm=4, edge_attention_sums_v1=4,
        edge_attention_sums_chunked=5)
    assert eaf.body_launch_counts()["edge_attention_sums_chunked"] == dict(
        tc=k8_bodies["tc"] + 2, simt=k8_bodies["simt"] + 3, tc_bf16=0, simt_bf16=0)


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,d,h", SHAPES)
def test_layer_mm_matches_plain_and_k2_on_card(cuda, s, d, h, softmax):
    """K7 against its plain version and against K2's layer on the same rows."""
    g, mask = graph(0)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    valid = edge_slot_valid(lay, mask.to(cuda))
    nt = lay.recv_ptr.numel() - 1
    sp = -(-s // 8) * 8
    gen = torch.Generator(device=cuda).manual_seed(1)
    x_rows = torch.randn(nt * sp, d, generator=gen, device=cuda)
    w = [t.to(cuda) for t in params(2, d)]
    deg = torch.bincount(g.receivers[mask], minlength=nt).to(cuda, torch.float32)
    invdeg = torch.where(deg > 0, 1.0 / deg.clamp_min(1.0), torch.zeros_like(deg))
    kw = dict(s=s, sp=sp, num_heads=h, softmax=softmax)
    slots = (lay.tile_senders, lay.tile_recv, valid, lay.tile_counts)
    before = eaf.launch_counts()
    got = eav.edge_attention_layer_mm(x_rows, *w, invdeg, *slots, **kw, tile_nodes=16)
    ref = eav.edge_attention_layer_mm_plain(x_rows, *w, invdeg, *slots, **kw,
                                            tile_nodes=16, group=eav.MM_GROUP)
    k2 = eaf.edge_attention_layer(x_rows, *w, invdeg, lay.tile_senders, valid,
                                  lay.recv_ptr, lay.recv_slots, **kw)
    torch.cuda.synchronize()
    after = eaf.launch_counts()
    assert {k: after[k] - before[k] for k in after} == launched(
        edge_attention_layer_mm=1, edge_attention_layer=1)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got, k2, rtol=RTOL, atol=ATOL)
    assert (got.reshape(nt, sp, d)[39] == 0).all()
    assert (got.reshape(nt, sp, d)[:, s:] == 0).all()


@pytest.mark.parametrize("route,grad,want", [
    ("mm-dma", False, dict(edge_attention_sums_mm=1)),
    ("mm-vmem", False, dict(edge_attention_layer_mm=1)),
    ("mm-vmem", True, dict(edge_attention_sums_mm=1, edge_attention_bwd_dq=1,
                           edge_attention_bwd_dkv=1)),
    ("v1-dma", False, dict(edge_attention_sums_v1=1)),
    ("v1-dma", True, dict(edge_attention_sums_v1=1, edge_attention_bwd_dq=1,
                          edge_attention_bwd_dkv=1)),
    ("v1-vmem", False, dict(edge_attention_layer=1)),
])
def test_fused_op_variant_routes_on_card(cuda, monkeypatch, route, grad, want):
    """mm_scatter and DMA_V1_DEFAULT pick K6 / K7 / K9 as the JAX dispatch
    does, forward and (the backward unchanged) gradients against the plain
    oracle on the CPU."""
    kind, gather = route.split("-")
    monkeypatch.setattr(eaf, "DMA_V1_DEFAULT", kind == "v1")
    g, mask = graph(3, first_sender=1)
    d, h, s = 128, 4, 20
    p = params(4, d)
    x = torch.randn(48, s, d, generator=torch.Generator().manual_seed(5))
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    leaves = [t.to(cuda).requires_grad_(grad) for t in (x, *p)]
    eaf.reset_launch_counts()
    out = eaf.amp_edge_attention_fused(
        leaves[0], MHAParams(*leaves[1:]), g.receivers.to(cuda), mask.to(cuda),
        lay.tile_senders, edge_slot_valid(lay, mask.to(cuda)), lay.recv_ptr,
        lay.recv_slots, h, tile_nodes=16, gather=gather,
        snd_receivers=lay.snd_receivers, snd_valid=snd_slot_valid(lay, mask.to(cuda)),
        snd_ptr=lay.snd_ptr, snd_slots=lay.snd_slots, mm_scatter=kind == "mm",
        tile_recv=lay.tile_recv, tile_counts=lay.tile_counts)
    cpu = [t.clone().requires_grad_(grad) for t in (x, *p)]
    ref, _ = amp_edge_attention(cpu[0], g.senders, g.receivers, mask, MHAParams(*cpu[1:]), h)
    torch.testing.assert_close(out.detach().cpu(), ref.detach(), rtol=RTOL, atol=ATOL)
    if grad:
        (out * out.cos()).sum().backward()
        (ref * ref.cos()).sum().backward()
        for name, a, b in zip(("x", "w_qkv", "b_qkv", "w_out", "b_out"), leaves, cpu):
            scale = float(b.grad.abs().max())
            torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=RTOL,
                                       atol=1e-5 * max(scale, 1.0),
                                       msg=lambda m: f"{name}: {m}")
    assert eaf.launch_counts() == launched(**want)


def test_variant_kernels_refuse_what_does_not_fit(cuda):
    """No silent fallback: a packed group that does not divide EMAX, K8's
    piece beyond its chunk, index arrays of another type, K6, K9 or K8
    named for their tensor-core body beyond its range, and D not a multiple
    of H raise before any launch. (K6's group of 8 and K8's piece of 8 at
    S=40 run: on the tensor cores neither takes shared memory, on the CUDA
    cores their working set goes to device memory.)"""
    g, _ = graph(0)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    nt = lay.recv_ptr.numel() - 1
    qkv = torch.zeros(nt * 40, 3 * 128, device=cuda)
    q, kv = qkv[:, :128], qkv[:, 128:]
    kw = dict(s=40, sp=40, num_heads=4, softmax=True)
    slots = (lay.tile_senders, lay.tile_recv, lay.tile_valid)
    with pytest.raises(ValueError, match="EMAX"):
        eav.edge_attention_sums_v1(q, kv, *slots, **kw, tile_nodes=16, group=5)
    ck = compute_chunked_layout(g, tile_nodes=16, chunk_edges=8).to(cuda)
    chunks = (ck.senders, ck.valid, ck.chunk_start, ck.chunk_count)
    with pytest.raises(ValueError, match="piece"):
        eav.edge_attention_sums_chunked(q, kv, *chunks, **kw, chunk=8, piece=9)
    with pytest.raises(ValueError, match="int32"):
        eav.edge_attention_sums_mm(q, kv, lay.tile_senders.long(), lay.tile_recv,
                                   lay.tile_valid, lay.tile_counts, **kw, tile_nodes=16)
    big = torch.zeros(nt * 56, 3 * 128, device=cuda)
    kw49 = dict(s=49, sp=56, num_heads=4, softmax=True)
    before = eaf.body_launch_counts()
    with pytest.raises(ValueError, match="range"):
        eav.edge_attention_sums_mm(big[:, :128], big[:, 128:], *slots, lay.tile_counts,
                                   **kw49, tile_nodes=16, body="tc")
    with pytest.raises(ValueError, match="range"):
        eav.edge_attention_sums_v1(big[:, :128], big[:, 128:], *slots, **kw49,
                                   tile_nodes=16, group=8, body="tc")
    with pytest.raises(ValueError, match="range"):
        eav.edge_attention_sums_chunked(big[:, :128], big[:, 128:], *chunks, **kw49, chunk=8,
                                        body="tc")
    with pytest.raises(ValueError, match="multiple of num_heads"):
        eav.edge_attention_sums_chunked(q, kv, *chunks, **dict(kw, num_heads=3), chunk=8)
    with pytest.raises(ValueError, match="at most 32"):
        eav.edge_attention_sums_mm(q, kv, *slots, lay.tile_counts, **kw, tile_nodes=16,
                                   group=33, body="simt")
    assert eaf.body_launch_counts() == before


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,d,h", [(96, 128, 4), (49, 128, 4), (40, 128, 8), (40, 6, 2)])
def test_edge_group_kernels_beyond_the_tensor_cores_match_plain(cuda, s, d, h, softmax):
    """K6, K7 and K9 where the tensor cores do not take the call: their
    CUDA-core bodies (S=96: K6 at its default group 1 and K9 with their
    working set in device memory) against their plain versions and K1's
    sums, each launch counted under the CUDA-core body, and under device
    memory where the shared-memory mirror says it does not fit (K7's
    attention launch under K6's name)."""
    g, mask = graph(0)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    valid = edge_slot_valid(lay, mask.to(cuda))
    nt = lay.recv_ptr.numel() - 1
    sp = -(-s // 8) * 8
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=cuda)
    q, kv = qkv[:, :d], qkv[:, d:]
    kw = dict(s=s, sp=sp, num_heads=h, softmax=softmax, tile_nodes=16)
    slots = (lay.tile_senders, lay.tile_recv, valid)
    k1 = eaf.edge_attention_sums(q, kv, lay.tile_senders, valid, lay.recv_ptr,
                                 lay.recv_slots, **{k: v for k, v in kw.items() if k != "tile_nodes"})
    x_rows = torch.randn(nt * sp, d, generator=gen, device=cuda)
    w, invdeg = layer_inputs(cuda, g, mask, nt, d)
    eaf.reset_launch_counts()
    for got, ref, other in (
            (eav.edge_attention_sums_mm(q, kv, *slots, lay.tile_counts, **kw),
             eav.edge_attention_sums_mm_plain(q, kv, *slots, lay.tile_counts, **kw,
                                              group=eav.MM_GROUP), k1),
            (eav.edge_attention_sums_v1(q, kv, *slots, **kw, group=8),
             eav.edge_attention_sums_v1_plain(q, kv, *slots, **kw, group=8), k1),
            (eav.edge_attention_layer_mm(x_rows, *w, invdeg, *slots, lay.tile_counts, **kw),
             eav.edge_attention_layer_mm_plain(x_rows, *w, invdeg, *slots, lay.tile_counts,
                                               **kw, group=eav.MM_GROUP), None)):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        if other is not None:
            torch.testing.assert_close(got, other, rtol=RTOL, atol=ATOL)
        assert (got.reshape(nt, sp, d)[:, s:] == 0).all()
    bodies = eaf.body_launch_counts()
    for k in ("edge_attention_sums_mm", "edge_attention_sums_v1", "edge_attention_layer_mm"):
        assert bodies[k] == dict(tc=0, simt=1, tc_bf16=0, simt_bf16=0), bodies
    expect = {k: n for k, group, n in (
        ("edge_attention_sums_mm", eav._mm_group("simt", s, d, h, None), 2),
        ("edge_attention_sums_v1", 8, 1))
        if launch.simt_smem_bytes(k, s, d, h, group) > launch.MAX_SMEM}
    assert eaf.device_memory_launch_counts() == expect
    assert s != 96 or len(expect) == 2


def test_group_shared_memory_mirror_matches_the_library(cuda):
    """launch.simt_smem_bytes against the CUDA-core groups library's own
    ampnet_edge_group_smem_bytes, K6's message buffer included."""
    import ctypes

    _, fn = launch.entry("edge_attention_groups", "ampnet_edge_group_smem_bytes",
                         [launch.I] * 4, ctypes.c_size_t)
    for s, d, h in [(40, 128, 4), (20, 128, 4), (40, 128, 8), (49, 128, 4), (96, 128, 4),
                    (7, 100, 4), (40, 3, 1)]:
        for group in (1, 4, 8, 32):
            assert launch.simt_smem_bytes("edge_attention_sums_mm", s, d, h, group) == \
                fn(s, d, h, group)
        assert launch.simt_smem_bytes("edge_attention_sums_v1", s, d, h, 8) == fn(s, d, h, 0)


def chunked_inputs(cuda, s, d, h, softmax, chunk=8):
    """K8's inputs on graph(0) (every 7th live edge masked at run time;
    partial chunks at C=8, receivers of several chunks at C=3) and K1's
    sums of the same rows."""
    g, mask = graph(0)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    ck = compute_chunked_layout(g, tile_nodes=16, chunk_edges=chunk).to(cuda)
    valid = chunk_slot_valid(ck, mask.to(cuda))
    assert int((ck.valid.reshape(-1, chunk).sum(1) % chunk).count_nonzero()) > 0  # partial
    assert int((valid != ck.valid).sum()) > 0                                      # masked
    nt = ck.chunk_start.numel()
    sp = -(-s // 8) * 8
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=cuda)
    kw = dict(s=s, sp=sp, num_heads=h, softmax=softmax)
    k1 = eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], lay.tile_senders,
                                 edge_slot_valid(lay, mask.to(cuda)), lay.recv_ptr,
                                 lay.recv_slots, **kw)
    return qkv[:, :d], qkv[:, d:], (ck.senders, valid, ck.chunk_start, ck.chunk_count), kw, k1


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,chunk", [(40, 8), (20, 8), (40, 3), (48, 8)])
def test_chunked_tensor_core_body_matches_plain_and_cuda_cores(cuda, s, chunk, softmax):
    """K8's tensor-core body at S=40 and S=20 (and S=48, its widest key
    tile), with a runtime mask and partial chunks: against the plain
    version, its CUDA-core body and K1's sums; pad token rows and a
    receiver of degree 0 exactly 0; a second launch repeats the first bit
    for bit; the launches counted by body."""
    d, h = 128, 4
    q, kv, chunks, kw, k1 = chunked_inputs(cuda, s, d, h, softmax, chunk)
    nt, sp = chunks[2].numel(), kw["sp"]
    before = eaf.body_launch_counts()["edge_attention_sums_chunked"]
    got = eav.edge_attention_sums_chunked(q, kv, *chunks, **kw, chunk=chunk)
    simt = eav.edge_attention_sums_chunked(q, kv, *chunks, **kw, chunk=chunk, body="simt")
    ref = eav.edge_attention_sums_chunked_plain(q, kv, *chunks, **kw, chunk=chunk)
    torch.cuda.synchronize()
    for other in (ref, simt, k1):
        torch.testing.assert_close(got, other, rtol=RTOL, atol=ATOL)
    assert (got.reshape(nt, sp, d)[39] == 0).all()
    assert (got.reshape(nt, sp, d)[:, s:] == 0).all()
    assert torch.equal(got, eav.edge_attention_sums_chunked(q, kv, *chunks, **kw, chunk=chunk))
    after = eaf.body_launch_counts()["edge_attention_sums_chunked"]
    assert after == dict(tc=before["tc"] + 2, simt=before["simt"] + 1, tc_bf16=0,
                         simt_bf16=0)


@pytest.mark.parametrize("s,d,h,piece,device_memory", [
    (96, 128, 4, None, True),     # 345 KB a block even at a piece of 1
    (49, 128, 4, None, False),    # beyond the tensor cores, shared memory at piece 1
    (40, 128, 4, 8, True),        # a named piece beyond shared memory
    (40, 128, 8, None, False),    # 24 warps
    (40, 6, 2, None, False),      # k|v rows of 6 floats: no 16-byte copies
])
def test_chunked_cuda_core_body_beyond_the_tensor_cores_matches_plain(
        cuda, s, d, h, piece, device_memory):
    """K8 where the tensor cores do not take the call: its CUDA-core body,
    its working set in device memory where the shared-memory mirror says it
    does not fit, against the plain version and K1's sums. The route picks
    that body by itself; the named piece at S=40 names it too (within the
    tensor cores' range)."""
    q, kv, chunks, kw, k1 = chunked_inputs(cuda, s, d, h, True)
    body = "simt" if piece else None
    eaf.reset_launch_counts()
    got = eav.edge_attention_sums_chunked(q, kv, *chunks, **kw, chunk=8, piece=piece, body=body)
    ref = eav.edge_attention_sums_chunked_plain(q, kv, *chunks, **kw, chunk=8)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got, k1, rtol=RTOL, atol=ATOL)
    assert (got.reshape(chunks[2].numel(), kw["sp"], d)[:, s:] == 0).all()
    assert torch.equal(got, eav.edge_attention_sums_chunked(q, kv, *chunks, **kw, chunk=8,
                                                            piece=piece, body=body))
    assert eaf.body_launch_counts()["edge_attention_sums_chunked"] == dict(
        tc=0, simt=2, tc_bf16=0, simt_bf16=0)
    assert eaf.device_memory_launch_counts() == (
        {"edge_attention_sums_chunked": 2} if device_memory else {})


def test_chunked_shared_memory_mirror_matches_the_library(cuda):
    """launch.simt_smem_bytes for K8 against the CUDA-core chunked
    library's own ampnet_edge_chunk_smem_bytes, at every piece of C=8."""
    import ctypes

    _, fn = launch.entry("edge_attention_chunked", "ampnet_edge_chunk_smem_bytes",
                         [launch.I] * 4, ctypes.c_size_t)
    for s, d, h in [(40, 128, 4), (20, 128, 4), (40, 128, 8), (49, 128, 4), (73, 128, 4),
                    (96, 128, 4), (7, 100, 4), (40, 3, 1)]:
        for piece in range(1, 9):
            assert launch.simt_smem_bytes("edge_attention_sums_chunked", s, d, h, piece) == \
                fn(s, d, h, piece)


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


# ---- K1-K4 on the tensor cores (3xTF32, a cp.async ring, persistent
# blocks), and their CUDA-core bodies, the route beyond the tensor cores' range


def hub_graph(seed):
    """Node 0 receives from 40 senders and node 1 sends to 40 receivers (the
    ring wraps many times within one node), with random edges beside them;
    every 7th other edge is masked at run time."""
    rng = np.random.default_rng(seed)
    n = 44
    x = (rng.random((n, 12)) < 0.4).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    hub = np.concatenate([np.stack([np.arange(2, 42), np.zeros(40, int)]),
                          np.stack([np.ones(40, int), np.arange(2, 42)])], axis=1)
    ei = np.concatenate([hub, np.stack([rng.integers(2, n, 100), rng.integers(2, n, 100)])], 1)
    split = rng.random(n)
    g = from_arrays(x, ei, y=rng.integers(0, 3, n), train_mask=split < 0.5,
                    val_mask=split >= 0.5, pad_nodes_to=48, pad_edges_to=256)
    mask = g.edge_mask.clone()
    other = torch.nonzero(mask & (g.receivers != 0) & (g.senders != 1))[:, 0]
    mask[other[::7]] = False
    return g, mask


def tc_inputs(cuda, g, mask, s, d, h, softmax):
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    nt = lay.recv_ptr.numel() - 1
    sp = -(-s // 8) * 8
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=cuda)
    qdm = torch.cat([qkv[:, :d], torch.randn(nt * sp, d, generator=gen, device=cuda)], 1)
    r_idx = (lay.tile_senders, edge_slot_valid(lay, mask.to(cuda)), lay.recv_ptr, lay.recv_slots)
    s_idx = (lay.snd_receivers, snd_slot_valid(lay, mask.to(cuda)), lay.snd_ptr, lay.snd_slots)
    return lay, nt, sp, qkv, qdm, r_idx, s_idx, dict(s=s, sp=sp, num_heads=h, softmax=softmax)


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s", [40, 20])
def test_tc_kernels_on_nodes_of_degree_40(cuda, s, softmax):
    """Sums over 40 edges: with raw scores their terms grow with the degree
    and cancel, so, as the gradient tests do for f32 sums, atol scales with
    the largest entry (the tensor cores add each product's 8-term sum with
    truncation: about twice the error of the CUDA-core kernels, PERF.md).
    K6 and K9 too, K6 also with groups of 64 slots (long runs of one
    receiver in a group)."""
    g, mask = hub_graph(0)
    d, h = 128, 4
    lay, nt, sp, qkv, qdm, r_idx, s_idx, kw = tc_inputs(cuda, g, mask, s, d, h, softmax)
    assert int(lay.recv_ptr[1] - lay.recv_ptr[0]) >= 40
    assert int(lay.snd_ptr[2] - lay.snd_ptr[1]) >= 40
    q, kv, dsum = qkv[:, :d], qkv[:, d:], qdm[:, d:]
    w, invdeg = layer_inputs(cuda, g, mask, nt, d)
    x_rows = q.contiguous()
    slots = (lay.tile_senders, lay.tile_recv, r_idx[1])
    gk = dict(**kw, tile_nodes=lay.tile_nodes)
    before = eaf.body_launch_counts()
    for got, ref in (
            (eaf.edge_attention_sums(q, kv, *r_idx, **kw),
             eaf.edge_attention_sums_plain(q, kv, *r_idx, **kw)),
            (eaf.edge_attention_layer(x_rows, *w, invdeg, *r_idx, **kw),
             eaf.edge_attention_layer_plain(x_rows, *w, invdeg, *r_idx, **kw)),
            (bwd.edge_attention_bwd_dq(q, kv, dsum, *r_idx, **kw),
             bwd.edge_attention_bwd_dq_plain(q, kv, dsum, *r_idx, **kw)),
            (bwd.edge_attention_bwd_dkv(qdm, kv, *s_idx, **kw),
             bwd.edge_attention_bwd_dkv_plain(qdm, kv, *s_idx, **kw)),
            *((eav.edge_attention_sums_mm(q, kv, *slots, lay.tile_counts, **gk, group=group),
               eav.edge_attention_sums_mm_plain(q, kv, *slots, lay.tile_counts, **gk,
                                                group=group or eav.MM_GROUP))
              for group in (None, 64)),
            (eav.edge_attention_sums_v1(q, kv, *slots, **gk, group=8),
             eav.edge_attention_sums_v1_plain(q, kv, *slots, **gk, group=8))):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=RTOL,
                                   atol=ATOL * max(1.0, float(ref.abs().max())))
    after = eaf.body_launch_counts()
    assert all(after[k]["tc"] == before[k]["tc"] + 1 for k in K1_TO_K4)
    assert after["edge_attention_sums_mm"]["tc"] == before["edge_attention_sums_mm"]["tc"] + 2
    assert after["edge_attention_sums_v1"]["tc"] == before["edge_attention_sums_v1"]["tc"] + 1


def test_tc_kernels_write_zeros_where_every_edge_is_masked(cuda):
    """The receiver 0 and the sender 1 keep their 40 structural edges, all
    masked at run time: no gather, exact zeros, and their neighbours'
    sums unchanged against the plain versions."""
    g, mask = hub_graph(1)
    mask = mask & (g.receivers != 0) & (g.senders != 1)
    d, h = 128, 4
    lay, nt, sp, qkv, qdm, r_idx, s_idx, kw = tc_inputs(cuda, g, mask, 40, d, h, True)
    assert int(lay.recv_ptr[1] - lay.recv_ptr[0]) >= 40
    got = eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], *r_idx, **kw)
    torch.cuda.synchronize()
    assert (got.reshape(nt, sp, d)[0] == 0).all()
    torch.testing.assert_close(got, eaf.edge_attention_sums_plain(
        qkv[:, :d], qkv[:, d:], *r_idx, **kw), rtol=RTOL, atol=ATOL)
    got = bwd.edge_attention_bwd_dkv(qdm, qkv[:, d:], *s_idx, **kw)
    torch.cuda.synchronize()
    assert (got.reshape(nt, sp, 2 * d)[1] == 0).all()
    torch.testing.assert_close(got, bwd.edge_attention_bwd_dkv_plain(
        qdm, qkv[:, d:], *s_idx, **kw), rtol=RTOL, atol=ATOL)
    got = bwd.edge_attention_bwd_dq(qkv[:, :d], qkv[:, d:], qdm[:, d:], *r_idx, **kw)
    torch.cuda.synchronize()
    assert (got.reshape(nt, sp, d)[0] == 0).all()
    torch.testing.assert_close(got, bwd.edge_attention_bwd_dq_plain(
        qkv[:, :d], qkv[:, d:], qdm[:, d:], *r_idx, **kw), rtol=RTOL, atol=ATOL)
    w, invdeg = layer_inputs(cuda, g, mask, nt, d)
    assert float(invdeg[0]) == 0.0
    x_rows = qkv[:, :d].contiguous()
    got = eaf.edge_attention_layer(x_rows, *w, invdeg, *r_idx, **kw)
    torch.cuda.synchronize()
    assert (got.reshape(nt, sp, d)[0] == 0).all()          # no b_out where no edge lives
    torch.testing.assert_close(got, eaf.edge_attention_layer_plain(
        x_rows, *w, invdeg, *r_idx, **kw), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s,d,h", [(40, 128, 4), (7, 100, 4)])
def test_tc_kernels_take_strided_views_and_repeat_bit_for_bit(cuda, s, d, h):
    """q / k|v as column views of one q|k|v buffer, [Q | dMsg] as a view of
    a wider buffer: the same bits as on contiguous copies, and a second
    launch repeats the first (no atomics)."""
    g, mask = graph(0, first_sender=1)
    lay, nt, sp, qkv, qdm, r_idx, s_idx, kw = tc_inputs(cuda, g, mask, s, d, h, True)
    q, kv = qkv[:, :d], qkv[:, d:]
    assert kv.stride(0) == 3 * d
    got = eaf.edge_attention_sums(q, kv, *r_idx, **kw)
    assert torch.equal(got, eaf.edge_attention_sums(q.contiguous(), kv.contiguous(), *r_idx, **kw))
    assert torch.equal(got, eaf.edge_attention_sums(q, kv, *r_idx, **kw))
    wide = torch.zeros(nt * sp, 2 * d + 8, device=cuda)
    wide[:, 4: 2 * d + 4] = qdm
    view = wide[:, 4: 2 * d + 4]
    got = bwd.edge_attention_bwd_dkv(view, kv, *s_idx, **kw)
    assert torch.equal(got, bwd.edge_attention_bwd_dkv(qdm, kv.contiguous(), *s_idx, **kw))
    assert torch.equal(got, bwd.edge_attention_bwd_dkv(view, kv, *s_idx, **kw))


def layer_inputs(cuda, g, mask, nt, d):
    """K2's weights and the runtime mask's 1/degree per receiver."""
    w = [t.to(cuda) for t in params(2, d)]
    deg = torch.bincount(g.receivers[mask], minlength=nt).to(cuda, torch.float32)
    return w, torch.where(deg > 0, 1.0 / deg.clamp_min(1.0), torch.zeros_like(deg))


def test_tc_kernels_refuse_what_they_do_not_take(cuda):
    """Called for their tensor-core body, the wrappers raise before any
    launch on rows the 16-byte copies cannot gather and on S beyond the
    instantiated range; left to the rule, they take the CUDA-core body
    there and agree with the plain versions."""
    g, mask = graph(0, first_sender=1)
    d = 128
    lay, nt, sp, qkv, qdm, r_idx, s_idx, kw = tc_inputs(cuda, g, mask, 40, d, 4, True)
    buf = torch.randn(nt * sp, 3 * d + 4, generator=torch.Generator(device=cuda).manual_seed(3),
                      device=cuda)
    before = eaf.body_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        eaf.edge_attention_sums(buf[:, :d], buf[:, d + 1: 3 * d + 1], *r_idx, **kw, body="tc")
    with pytest.raises(ValueError, match="16-byte"):
        bwd.edge_attention_bwd_dq(buf[:, :d], buf[:, d + 1: 3 * d + 1], qdm[:, d:], *r_idx,
                                  **kw, body="tc")
    with pytest.raises(ValueError, match="16-byte"):
        bwd.edge_attention_bwd_dkv(buf[:, 1: 2 * d + 1], qkv[:, d:], *s_idx, **kw, body="tc")
    # beyond every tensor-core body's range (K1, K3 and K4 reach S=64)
    big = torch.randn(nt * 72, 3 * d, generator=torch.Generator(device=cuda).manual_seed(4),
                      device=cuda)
    kw65 = dict(s=65, sp=72, num_heads=4, softmax=True)
    with pytest.raises(ValueError, match="range"):
        eaf.edge_attention_sums(big[:, :d], big[:, d:], *r_idx, **kw65, body="tc")
    with pytest.raises(ValueError, match="range"):
        bwd.edge_attention_bwd_dkv(big[:, : 2 * d], big[:, d:], *s_idx, **kw65, body="tc")
    with pytest.raises(ValueError, match="16-byte"):
        sb.edge_attention_bwd_stream(buf[:, :d], buf[:, d + 1: 3 * d + 1], qdm[:, d:], *r_idx,
                                     **kw, body="tc")
    with pytest.raises(ValueError, match="range"):
        sb.edge_attention_bwd_stream(big[:, :d], big[:, d:], big[:, :d], *r_idx, **kw65,
                                     body="tc")
    assert eaf.body_launch_counts() == before

    q, kv = buf[:, :d], buf[:, d + 1: 3 * d + 1]
    for got, ref in (
            (eaf.edge_attention_sums(q, kv, *r_idx, **kw),
             eaf.edge_attention_sums_plain(q, kv, *r_idx, **kw)),
            (bwd.edge_attention_bwd_dq(q, kv, qdm[:, d:], *r_idx, **kw),
             bwd.edge_attention_bwd_dq_plain(q, kv, qdm[:, d:], *r_idx, **kw)),
            (eaf.edge_attention_sums(big[:, :d], big[:, d:], *r_idx, **kw65),
             eaf.edge_attention_sums_plain(big[:, :d], big[:, d:], *r_idx, **kw65)),
            # K4's CUDA-core body at 353 KB: its working set in device memory
            (bwd.edge_attention_bwd_dkv(big[:, : 2 * d], big[:, d:], *s_idx, **kw65),
             bwd.edge_attention_bwd_dkv_plain(big[:, : 2 * d], big[:, d:], *s_idx, **kw65))):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    # K5 left to the rule on the same rows: its CUDA-core body, dQ and the walked stream
    walked = lay.recv_slots.long()
    for args, kw_ in (((q, kv, qdm[:, d:]), kw), ((big[:, :d], big[:, d:], big[:, :d]), kw65)):
        (dq, st), (dq_ref, st_ref) = (f(*args, *r_idx, **kw_) for f in (
            sb.edge_attention_bwd_stream, sb.edge_attention_bwd_stream_plain))
        torch.cuda.synchronize()
        rows = (-1, kw_["sp"], 2 * d)
        torch.testing.assert_close(dq, dq_ref, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(st.view(rows)[walked], st_ref.view(rows)[walked],
                                   rtol=RTOL, atol=ATOL)
    after = eaf.body_launch_counts()
    assert after["edge_attention_sums"]["simt"] == before["edge_attention_sums"]["simt"] + 2
    assert after["edge_attention_bwd_dq"]["simt"] == before["edge_attention_bwd_dq"]["simt"] + 1
    assert after["edge_attention_bwd_dkv"]["simt"] == before["edge_attention_bwd_dkv"]["simt"] + 1
    assert after["edge_attention_bwd_stream"] == dict(
        tc=before["edge_attention_bwd_stream"]["tc"],
        simt=before["edge_attention_bwd_stream"]["simt"] + 2, tc_bf16=0, simt_bf16=0)


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,d,h", SHAPES)
def test_simt_baselines_match_plain_on_card(cuda, s, d, h, softmax):
    """The CUDA-core bodies of K1-K4, named by ``body``, against the same
    plain versions; each launch counts under its body."""
    g, mask = graph(0, first_sender=1)
    lay, nt, sp, qkv, qdm, r_idx, s_idx, kw = tc_inputs(cuda, g, mask, s, d, h, softmax)
    q, kv, dsum = qkv[:, :d], qkv[:, d:], qdm[:, d:]
    w, invdeg = layer_inputs(cuda, g, mask, nt, d)
    x_rows = q.contiguous()
    before = eaf.body_launch_counts()
    for got, ref in (
            (eaf.edge_attention_sums(q, kv, *r_idx, **kw, body="simt"),
             eaf.edge_attention_sums_plain(q, kv, *r_idx, **kw)),
            (eaf.edge_attention_layer(x_rows, *w, invdeg, *r_idx, **kw, body="simt"),
             eaf.edge_attention_layer_plain(x_rows, *w, invdeg, *r_idx, **kw)),
            (bwd.edge_attention_bwd_dq(q, kv, dsum, *r_idx, **kw, body="simt"),
             bwd.edge_attention_bwd_dq_plain(q, kv, dsum, *r_idx, **kw)),
            (bwd.edge_attention_bwd_dkv(qdm, kv, *s_idx, **kw, body="simt"),
             bwd.edge_attention_bwd_dkv_plain(qdm, kv, *s_idx, **kw))):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    after = eaf.body_launch_counts()
    assert all(after[k] == dict(before[k], simt=before[k]["simt"] + 1) for k in K1_TO_K4)


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,d,h", SHAPES)
def test_k2_k3_tensor_core_bodies_match_plain_and_cuda_cores(cuda, s, d, h, softmax):
    """K2 (both launches) and K3 on the tensor cores against their plain
    versions and their CUDA-core bodies on the same inputs, receivers of
    degree 0 exact zeros, and a second launch bit-equal to the first."""
    g, mask = graph(0, first_sender=1)
    lay, nt, sp, qkv, qdm, r_idx, s_idx, kw = tc_inputs(cuda, g, mask, s, d, h, softmax)
    q, kv, dsum = qkv[:, :d], qkv[:, d:], qdm[:, d:]
    w, invdeg = layer_inputs(cuda, g, mask, nt, d)
    x_rows = q.contiguous()
    for run, plain in (
            (lambda body: bwd.edge_attention_bwd_dq(q, kv, dsum, *r_idx, **kw, body=body),
             lambda: bwd.edge_attention_bwd_dq_plain(q, kv, dsum, *r_idx, **kw)),
            (lambda body: eaf.edge_attention_layer(x_rows, *w, invdeg, *r_idx, **kw, body=body),
             lambda: eaf.edge_attention_layer_plain(x_rows, *w, invdeg, *r_idx, **kw))):
        got, simt, ref = run("tc"), run("simt"), plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got, simt, rtol=RTOL, atol=ATOL)
        assert (got.reshape(nt, sp, d)[39] == 0).all()       # receiver of degree 0
        assert (got.reshape(nt, sp, d)[:, s:] == 0).all()    # pad token rows
        assert torch.equal(got, run("tc"))
    qkv_tc = eav.layer_projection(x_rows, w[0], w[1], "tc")
    torch.testing.assert_close(qkv_tc, x_rows @ w[0] + w[1], rtol=RTOL, atol=ATOL)


def test_simt_shared_memory_mirror_matches_the_libraries(cuda):
    """launch.simt_smem_bytes against the CUDA-core libraries' own
    *_smem_bytes entry points, across the fault list's shapes."""
    import ctypes

    _, k1 = launch.entry("edge_attention", "ampnet_edge_attention_smem_bytes",
                         [launch.I] * 3, ctypes.c_size_t)
    _, k34 = launch.entry("edge_attention_bwd", "ampnet_edge_attention_bwd_smem_bytes",
                          [launch.I] * 4, ctypes.c_size_t)
    for s, d, h in [(40, 128, 4), (20, 128, 4), (40, 128, 8), (49, 128, 4), (96, 128, 4),
                    (7, 100, 4), (40, 3, 1), (33, 64, 2), (64, 128, 4)]:
        for kernel in ("edge_attention_sums", "edge_attention_layer"):
            assert launch.simt_smem_bytes(kernel, s, d, h) == k1(s, d, h)
        for mode, kernel in enumerate(("edge_attention_bwd_dq", "edge_attention_bwd_dkv",
                                       "edge_attention_bwd_stream")):
            assert launch.simt_smem_bytes(kernel, s, d, h) == k34(s, d, h, mode)


@pytest.mark.parametrize("s,d,h,want", [
    (40, 128, 2, "simt"), (20, 128, 8, "simt"), (40, 128, 8, "simt"), (40, 3, 1, "simt"),
    (40, 100, 4, "tc"), (49, 128, 4, "tc"), (65, 128, 4, "simt"),
    (96, 128, 4, "simt")])
def test_fused_op_routes_beyond_the_tensor_cores(cuda, s, d, h, want):
    """The fused op at shapes the tensor-core bodies do not take: the
    forward and the five gradients through the CUDA-core bodies (the
    launches say which body ran: ``want`` for K1, K4 and K3, or one for all;
    at S=49 all three on the tensor cores; at S=65 K3's and K4's and
    at S=96 every working set in device memory) against autograd through
    the plain oracle on the CPU."""
    g, mask = graph(3, first_sender=1)
    p = params(4, d)
    x = torch.randn(48, s, d, generator=torch.Generator().manual_seed(5))
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    leaves = [t.to(cuda).requires_grad_() for t in (x, *p)]
    eaf.reset_launch_counts()
    out = eaf.amp_edge_attention_fused(
        leaves[0], MHAParams(*leaves[1:]), g.receivers.to(cuda), mask.to(cuda),
        lay.tile_senders, edge_slot_valid(lay, mask.to(cuda)), lay.recv_ptr,
        lay.recv_slots, h, tile_nodes=16, snd_receivers=lay.snd_receivers,
        snd_valid=snd_slot_valid(lay, mask.to(cuda)), snd_ptr=lay.snd_ptr,
        snd_slots=lay.snd_slots)
    (out * out.cos()).sum().backward()
    bodies = eaf.body_launch_counts()
    wants = (want.split() * 3)[:3]
    for k, w in zip(("edge_attention_sums", "edge_attention_bwd_dkv", "edge_attention_bwd_dq"),
                    wants):
        assert bodies[k][w] == 1 and sum(bodies[k].values()) == 1, bodies
    cpu = [t.clone().requires_grad_() for t in (x, *p)]
    ref, _ = amp_edge_attention(cpu[0], g.senders, g.receivers, mask, MHAParams(*cpu[1:]), h)
    torch.testing.assert_close(out.detach().cpu(), ref.detach(), rtol=RTOL, atol=ATOL)
    (ref * ref.cos()).sum().backward()
    for name, a, b in zip(("x", "w_qkv", "b_qkv", "w_out", "b_out"), leaves, cpu):
        scale = float(b.grad.abs().max())
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=RTOL, atol=1e-5 * max(scale, 1.0),
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s", [20, 40, 48])
def test_stream_tensor_core_body_matches_plain_and_cuda_cores(cuda, s, softmax):
    """K5 on the tensor cores (the hub graph: a receiver of in-degree 40,
    every 7th other edge masked at run time) against its plain version and
    its CUDA-core body: dQ, and the stream rows of the walked slots, masked
    slots 0, rows S..SP-1 0; over a range of tiles the same rows as in the
    whole launch; two launches bit-equal."""
    g, mask = hub_graph(2)
    d, h = 128, 4
    lay, nt, sp, qkv, qdm, r_idx, _, kw = tc_inputs(cuda, g, mask, s, d, h, softmax)
    t, emax = lay.tile_senders.shape
    q, kv, dsum = qkv[:, :d], qkv[:, d:], qdm[:, d:]
    slots = lay.recv_slots.long()
    rows = (t * emax, sp, 2 * d)
    before = eaf.body_launch_counts()["edge_attention_bwd_stream"]
    dq, st = sb.edge_attention_bwd_stream(q, kv, dsum, *r_idx, **kw)
    dq_simt, st_simt = sb.edge_attention_bwd_stream(q, kv, dsum, *r_idx, **kw, body="simt")
    dq_ref, st_ref = sb.edge_attention_bwd_stream_plain(q, kv, dsum, *r_idx, **kw)
    torch.cuda.synchronize()
    assert eaf.body_launch_counts()["edge_attention_bwd_stream"] == dict(
        tc=before["tc"] + 1, simt=before["simt"] + 1, tc_bf16=0, simt_bf16=0)
    got = st.view(rows)[slots]
    scale = max(1.0, float(dq_ref.abs().max()), float(st_ref.abs().max()))
    for a, b in ((dq, dq_ref), (dq, dq_simt), (got, st_ref.view(rows)[slots]),
                 (got, st_simt.view(rows)[slots])):
        # sums over 40 edges with raw scores grow with the degree: atol by the largest entry
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL * scale)
    assert (got[:, s:] == 0).all()
    dropped = r_idx[1].reshape(-1)[slots] == 0
    assert dropped.any() and (got[dropped] == 0).all()
    dq2, st2 = sb.edge_attention_bwd_stream(q, kv, dsum, *r_idx, **kw)
    assert torch.equal(dq, dq2) and torch.equal(got, st2.view(rows)[slots])
    tn = lay.tile_nodes
    dq_part, st_part = sb.edge_attention_bwd_stream(q, kv, dsum, *r_idx, **kw, tiles=(1, t))
    in_range = slots >= emax
    assert torch.equal(dq_part, dq[tn * sp:])
    assert torch.equal(st_part.view(-1, sp, 2 * d)[slots[in_range] - emax], got[in_range])


@pytest.mark.parametrize("s,d,h", [(20, 128, 4), (40, 128, 4), (20, 100, 4)])
def test_layer_mm_tensor_core_launches_match_plain_and_k2(cuda, s, d, h):
    """K7's three launches on the tensor cores (the projections on K2's
    tiled 3xTF32 product) against its plain version, its CUDA-core body and
    K2's layer; each projection launch against the CUDA cores' on the same
    inputs; receivers of degree 0 exactly 0, pad rows 0."""
    g, mask = hub_graph(3)
    lay, nt, sp, qkv, _, r_idx, _, kw = tc_inputs(cuda, g, mask, s, d, h, True)
    w, invdeg = layer_inputs(cuda, g, mask, nt, d)
    x_rows = qkv[:, :d].contiguous()
    slots = (lay.tile_senders, lay.tile_recv, r_idx[1], lay.tile_counts)
    mm = dict(**kw, tile_nodes=lay.tile_nodes)
    before = eaf.body_launch_counts()["edge_attention_layer_mm"]
    got = eav.edge_attention_layer_mm(x_rows, *w, invdeg, *slots, **mm)
    simt = eav.edge_attention_layer_mm(x_rows, *w, invdeg, *slots, **mm, body="simt")
    ref = eav.edge_attention_layer_mm_plain(x_rows, *w, invdeg, *slots, **mm,
                                            group=eav.MM_GROUP)
    k2 = eaf.edge_attention_layer(x_rows, *w, invdeg, *r_idx, **kw)
    torch.cuda.synchronize()
    assert eaf.body_launch_counts()["edge_attention_layer_mm"] == dict(
        tc=before["tc"] + 1, simt=before["simt"] + 1, tc_bf16=0, simt_bf16=0)
    for other in (ref, simt, k2):
        torch.testing.assert_close(got, other, rtol=RTOL, atol=ATOL)
    live = torch.zeros(nt, dtype=torch.bool, device=cuda)
    live[g.receivers[mask].to(cuda)] = True
    assert (~live).any() and (got.view(nt, sp, d)[~live] == 0).all()
    assert (got.view(nt, sp, d)[:, s:] == 0).all()
    qkv_tc = eav.layer_projection(x_rows, w[0], w[1], "tc")
    torch.testing.assert_close(qkv_tc, eav.layer_projection(x_rows, w[0], w[1], "simt"),
                               rtol=RTOL, atol=ATOL)
    sums = torch.randn(nt * sp, d, generator=torch.Generator(device=cuda).manual_seed(7),
                       device=cuda)
    out = {b: eav._layer_mm_out_projection(sums, invdeg, *w[2:], s=s, sp=sp, body=b)
           for b in ("tc", "simt")}
    torch.testing.assert_close(out["tc"], out["simt"], rtol=RTOL, atol=ATOL)
    assert (out["tc"].view(nt, sp, d)[invdeg == 0] == 0).all()     # no b_out, zero scale


# ---- the steps as captured CUDA graphs (train/graphs.py) against the eager
# bodies on the card: bit for bit, the GCN head's segment sums being
# repeatable (ops/segment.py) and K1-K4 free of atomics


CAPTURE_CFG = dict(embedding_dim=16, num_heads=2, num_node_features=12,
                   num_sampled_vectors=5, output_dim=3, feat_emb_dim=15, val_emb_dim=1,
                   token_sampling="tfidf", raw_residual="gcn2", dropout_rate=0.3,
                   dropout_adj_rate=0.1, use_pallas=True)


def step_problem(cuda):
    """A graph, its layout and a maker of equal training states (model,
    capturable Adam with clip and a cosine schedule, generator)."""
    from ampnet_tpu_torch.train import create_train_state, make_optimizer

    g, _ = graph(11)
    g = g.to(cuda)
    cfg = AMPGCNConfig(**CAPTURE_CFG)

    def make():
        model = AMPGCN(cfg, generator=torch.Generator().manual_seed(1), device=cuda)
        opt = make_optimizer(model.parameters(), 3e-3, weight_decay=1e-3, grad_clip=1.0,
                             cosine_t0=3, cosine_t_mult=1)
        return create_train_state(model, opt, seed=4)
    return g, compute_layout(g, tile_nodes=16), make


def assert_same_state(a, b):
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
    for p, q in zip(a.optimizer.params, b.optimizer.params):
        for name, t in a.optimizer.adam.state[p].items():
            assert torch.equal(t, b.optimizer.adam.state[q][name]), name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.step == b.step and a.optimizer.count == b.optimizer.count


def test_captured_steps_match_eager_bit_for_bit(cuda):
    """Four captured single steps and one captured 4-step graph against four
    eager bodies from one initial state: every metric, parameter, Adam
    tensor and the generator bit for bit; a 2-draw captured eval against
    the eager eval at two seeds, and the caller's generator advanced alike."""
    from ampnet_tpu_torch.train import make_eval_step, make_scan_train_step, make_train_step
    from ampnet_tpu_torch.train.state import _eval_step_body, _train_step_body

    g, lay, make = step_problem(cuda)
    eager, one, scan = make(), make(), make()
    body = _train_step_body(eager.model)
    rows = [body(eager, g, lay)[1] for _ in range(4)]
    step = make_train_step(one.model)
    ones = [step(one, g, lay)[1] for _ in range(4)]
    _, stacked = make_scan_train_step(scan.model, num_steps=4)(scan, g, lay)
    for k in rows[0]:
        want = torch.stack([r[k] for r in rows])
        assert torch.equal(torch.stack([r[k] for r in ones]), want), k
        assert torch.equal(stacked[k], want), k
    assert len(set(stacked["loss"].tolist())) == 4
    assert_same_state(one, eager)
    assert_same_state(scan, eager)

    ev, ev_body = make_eval_step(eager.model, 2), _eval_step_body(eager.model, 2)
    for seed in (0, 1):
        ga, gb = (torch.Generator(device=cuda).manual_seed(seed) for _ in range(2))
        got, want = ev(g, ga, lay), ev_body(g, gb, lay)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(ga.get_state(), gb.get_state())

    # F: the fused-closure step on a layout without a sender side (K1, K5 and
    # pass B in its fixed order), three captured steps against three eager
    # bodies: bit for bit too
    from ampnet_tpu_torch.train import create_train_state, make_optimizer
    from ampnet_tpu_torch.train.pallas_step import fused_forward, make_pallas_train_step

    cfg_f = AMPGCNConfig(**{**CAPTURE_CFG, "dropout_adj_rate": 0.0})

    def make_f():
        model = AMPGCN(cfg_f, generator=torch.Generator().manual_seed(1), device=cuda)
        return create_train_state(model, make_optimizer(
            model.parameters(), 3e-3, weight_decay=1e-3, grad_clip=1.0, cosine_t0=3,
            cosine_t_mult=1), seed=4)

    lay_f = compute_layout(g, tile_nodes=16, edges_per_tile=256, sender_layout=False)
    f_eager, f_one = make_f(), make_f()
    body_f = _train_step_body(f_eager.model, forward=fused_forward(f_eager.model))
    step_f = make_pallas_train_step(f_one.model, "full")
    eaf.reset_launch_counts()
    for _ in range(3):
        want, got = body_f(f_eager, g, lay_f)[1], step_f(f_one, g, lay_f)[1]
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert eaf.launch_counts() == launched(edge_attention_sums=12,
                                           edge_attention_bwd_stream=12)
    assert_same_state(f_one, f_eager)


def test_captured_steps_count_their_launches_per_replay(cuda):
    """Each replay adds the launches its capture recorded, by kernel and by
    body: a captured step counts as the eager body does; the warm-up and
    the capture count nothing."""
    from ampnet_tpu_torch.train import make_eval_step, make_scan_train_step, make_train_step
    from ampnet_tpu_torch.train.state import _eval_step_body, _train_step_body

    g, lay, make = step_problem(cuda)
    st = make()

    def counted(fn):
        eaf.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return eaf.launch_counts(), eaf.body_launch_counts()

    probe = make()
    want, want_bodies = counted(lambda: _train_step_body(probe.model)(probe, g, lay))
    assert want == launched(edge_attention_sums=2, edge_attention_bwd_dq=2,
                            edge_attention_bwd_dkv=2)
    step = make_train_step(st.model)
    assert counted(lambda: step(st, g, lay)) == (want, want_bodies)    # capture + replay
    assert counted(lambda: step(st, g, lay)) == (want, want_bodies)    # replay
    got, _ = counted(lambda: make_scan_train_step(st.model, num_steps=3)(st, g, lay))
    assert got == {k: 3 * n for k, n in want.items()}
    ev_want, _ = counted(lambda: _eval_step_body(st.model, 2)(
        g, torch.Generator(device=cuda).manual_seed(0), lay))
    ev = make_eval_step(st.model, 2)
    for _ in range(2):
        got, _ = counted(lambda: ev(g, torch.Generator(device=cuda).manual_seed(0), lay))
        assert got == ev_want and sum(got.values()) == 4


def test_replay_after_load_state_dict(cuda, monkeypatch):
    """model.load_state_dict copies in place: the graph replays on the new
    values. Optimizer.load_state_dict replaces Adam's tensors: the next
    call captures again. Both against the eager body on a twin state."""
    import io

    from ampnet_tpu_torch.train import graphs, make_train_step
    from ampnet_tpu_torch.train.state import _train_step_body

    captures = []

    class Counting(graphs.Captured):
        def __init__(self, *a, **k):
            captures.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(graphs, "Captured", Counting)
    g, lay, make = step_problem(cuda)
    st, ref = make(), make()
    step, body = make_train_step(st.model), _train_step_body(ref.model)
    for _ in range(2):
        step(st, g, lay)
        body(ref, g, lay)
    params = {k: v.clone() for k, v in st.model.state_dict().items()}
    step(st, g, lay)
    body(ref, g, lay)
    for s in (st, ref):
        s.model.load_state_dict(params)
    step(st, g, lay)
    body(ref, g, lay)
    assert len(captures) == 1
    assert_same_state(st, ref)

    buf = io.BytesIO()
    torch.save(st.optimizer.state_dict(), buf)
    for s in (st, ref):
        buf.seek(0)
        s.optimizer.load_state_dict(torch.load(buf, map_location="cpu", weights_only=True))
    step(st, g, lay)
    body(ref, g, lay)
    assert len(captures) == 2
    assert_same_state(st, ref)


def test_a_capture_that_breaks_raises_and_runs_nothing(cuda):
    """A host read in the body (.item()) breaks the capture: the step
    raises CaptureError naming that line, and leaves the state, the
    generator and the launch counts as they were; a sound step then
    captures and runs."""
    from ampnet_tpu_torch.train import make_train_step
    from ampnet_tpu_torch.train.graphs import CaptureError

    g, lay, make = step_problem(cuda)
    st = make()

    def forward(graph, layout, generator):
        logits = st.model(graph, deterministic=False, generator=generator, edge_layout=layout)
        assert logits.sum().item() == logits.sum().item()    # a host read
        return logits

    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    gen = st.generator.get_state()
    eaf.reset_launch_counts()
    with pytest.raises(CaptureError, match=r"\.item\(\)"):
        make_train_step(st.model, forward=forward)(st, g, lay)
    assert st.step == 0 and st.optimizer.count == 0
    assert torch.equal(st.generator.get_state(), gen)
    assert sum(eaf.launch_counts().values()) == 0
    for k, v in st.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    _, metrics = make_train_step(st.model)(st, g, lay)
    assert torch.isfinite(metrics["loss"]) and st.step == 1


def test_segment_sum_on_card_repeats_and_matches_cpu(cuda):
    """The card's segment sum (sorted, in input order per segment, masked
    rows spread over the segments) repeats bit for bit, matches the CPU's
    index_add_, and passes each row's gradient back."""
    from ampnet_tpu_torch.ops.segment import segment_count, segment_sum

    rng = np.random.default_rng(0)
    e, n = 3000, 50
    ids = torch.from_numpy(rng.integers(0, n, e))
    ids[:1000] = 0                                  # a padding's long run at node 0
    mask = torch.from_numpy(rng.random(e) < 0.7)
    mask[:1000] = False
    data = torch.from_numpy(rng.normal(size=(e, 16)).astype(np.float32))
    ref = segment_sum(data, ids, n, mask)
    x = data.to(cuda).requires_grad_()
    got = segment_sum(x, ids.to(cuda), n, mask.to(cuda))
    assert torch.equal(got, segment_sum(x, ids.to(cuda), n, mask.to(cuda)))
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-6, atol=1e-5)
    w = torch.randn(n, 16, device=cuda)
    (got * w).sum().backward()
    want = torch.where(mask.to(cuda)[:, None], w[ids.to(cuda)], torch.zeros_like(x))
    assert torch.equal(x.grad, want)
    assert torch.equal(segment_count(ids.to(cuda), n, mask.to(cuda)).cpu(),
                       segment_count(ids, n, mask))


def test_pass_b_on_card_repeats_bit_for_bit(cuda):
    """Pass B (the sorted fixed-order sum by sender) run twice gives the
    same bits, and the CPU's index_add_ sums within 1e-6 relative."""
    g, mask = graph(5, n=40, e=200)
    lay = compute_layout(g, tile_nodes=16, edges_per_tile=256, sender_layout=False)
    s, sp, d, h = 20, 24, 128, 4
    nt = lay.recv_ptr.numel() - 1
    rng = torch.Generator().manual_seed(0)
    q, kv, dsum = (torch.randn(nt * sp, c, generator=rng) for c in (d, 2 * d, d))
    idx = [t.to(cuda) for t in (lay.tile_senders, edge_slot_valid(lay, mask), lay.recv_ptr,
                                lay.recv_slots)]
    kw = dict(s=s, sp=sp, num_heads=h, softmax=True)
    _, stream = sb.edge_attention_bwd_stream(q.to(cuda), kv.to(cuda), dsum.to(cuda), *idx, **kw)
    take = sb.walked_slots(idx[0], idx[2], (0, idx[0].shape[0]))
    runs = [sb.stream_to_senders(stream, idx[0], take, 0,
                                 torch.zeros(nt, s, 2 * d, device=cuda), s=s, sp=sp)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    rows = stream.view(-1, sp, 2 * d)[:, :s].cpu()
    want = torch.zeros(nt, s, 2 * d).index_add_(
        0, lay.tile_senders.reshape(-1)[take.cpu()].long(), rows[take.cpu()])
    scale = float(want.abs().max())
    torch.testing.assert_close(runs[0].cpu(), want, rtol=1e-6, atol=1e-6 * scale)


PREDICT_CFG = dict(embedding_dim=16, num_heads=2, num_node_features=12,
                   num_sampled_vectors=5, output_dim=3, feat_emb_dim=15, val_emb_dim=1,
                   token_sampling="tfidf", raw_residual="gcn2", use_pallas=True)


def requests(seed, sizes):
    rng = np.random.default_rng(seed)
    out = []
    for n, e in sizes:
        x = (rng.random((n, 12)) < 0.4).astype(np.float32)
        x[x.sum(1) == 0, 0] = 1.0
        out.append((x, np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])))
    return out


@pytest.mark.parametrize("over", [dict(), dict(transformer_block=True, average_pooling=False)])
def test_predictor_replay_equals_its_eager_body(cuda, over):
    """Each answer of the Predictor (one captured graph per bucket) equals
    the eager forward from the same generator state on the same graph and
    layout, bit for bit; two buckets, two captures; at these sizes the
    whole layer fits (the JAX predicate's v6): K2 twice a request."""
    from ampnet_tpu_torch.serving import Predictor

    model = AMPGCN(AMPGCNConfig(**{**PREDICT_CFG, **over}), device=cuda)
    pred = Predictor(model, seed=3, bucket_nodes=32, bucket_edges=128)
    for x, ei in requests(0, ((20, 60), (25, 90), (50, 200))):
        state = pred.generator.get_state()
        eaf.reset_launch_counts()
        got = pred.predict(x, ei)
        assert eaf.launch_counts() == launched(edge_attention_layer=2)
        pn, pe = pred._bucket(x.shape[0], ei.shape[1])
        g = from_arrays(x, ei, pad_nodes_to=pn, pad_edges_to=pe).to(cuda)
        gen = torch.Generator(device=cuda)
        gen.set_state(state)
        with torch.no_grad():
            want = model(g, generator=gen, edge_layout=pred.layout(g))[: x.shape[0]]
        assert torch.equal(torch.from_numpy(got), want.cpu())
        assert torch.equal(pred.generator.get_state(), gen.get_state())
    assert len(pred.step.graphs.timings()) == 2


def test_predictor_hot_swap_needs_no_new_capture(cuda, tmp_path, monkeypatch):
    """load_params copies a checkpoint's params into the tensors the captured
    graph reads: the next answer uses them (equal to the eager forward with
    the new weights, unlike the one before) with no new capture."""
    from ampnet_tpu_torch.serving import Predictor
    from ampnet_tpu_torch.train import create_train_state, graphs, make_optimizer
    from ampnet_tpu_torch.train import save_checkpoint

    captures = []

    class Counting(graphs.Captured):
        def __init__(self, *a, **k):
            captures.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(graphs, "Captured", Counting)
    cfg = AMPGCNConfig(**PREDICT_CFG)
    other = AMPGCN(cfg, generator=torch.Generator().manual_seed(8), device=cuda)
    path = save_checkpoint(str(tmp_path / "ck.pkl"), create_train_state(
        other, make_optimizer(other.parameters(), 1e-3)), epoch=0)
    model = AMPGCN(cfg, device=cuda)
    pred = Predictor(model, seed=1, bucket_nodes=32, bucket_edges=128)
    (x, ei), = requests(2, ((20, 60),))
    state = pred.generator.get_state()
    before = pred.predict(x, ei)
    pred.load_params(path)
    pred.generator.set_state(state)
    after = pred.predict(x, ei)
    assert len(captures) == 1 and not np.array_equal(before, after)
    g = from_arrays(x, ei, pad_nodes_to=32, pad_edges_to=128).to(cuda)
    gen = torch.Generator(device=cuda)
    gen.set_state(state)
    with torch.no_grad():
        want = other(g, generator=gen, edge_layout=pred.layout(g))[:20]
    assert torch.equal(torch.from_numpy(after), want.cpu())


# ---- bf16: the tensor-core bodies in bf16 products (K1-K7, K9), the
# CUDA-core bodies in bf16 products (K1-K9) and K8's bf16 tensor-core body,
# the refusals that remain, and a bf16 model's captured steps

# bf16 body vs its plain version on the card, relative to the output's
# largest entry: one bf16 step (2**-8). The products are exact in f32 and
# the operands round at the same points, so they differ in the order of f32
# sums, and where that moves a softmax weight or dS (K2: its mean) across a
# bf16 rounding boundary, one term moves by a bf16 step of its own size;
# K2's bf16 output is itself rounded: two steps
BF16_LIMIT, BF16_OUT_LIMIT = 2.0 ** -8, 2 * 2.0 ** -8


def close_to_largest(got, ref, limit):
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    assert err <= limit * float(ref.abs().max()), (err, float(ref.abs().max()))
    return err


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,d,h", [(40, 128, 4), (20, 128, 4), (4, 16, 2)])
def test_bf16_bodies_match_plain_on_card(cuda, s, d, h, softmax):
    """K1 (bf16 rows; f32 rows under mxu_bf16), K2 (bf16 rows; f32 rows
    under mxu_bf16), K3 and K4 (bf16 rows) on their bf16 body against their
    plain versions, each launched twice and equal bit for bit, on tc_bf16."""
    g, mask = graph(0, first_sender=1)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    nt = lay.recv_ptr.numel() - 1
    sp = -(-s // 16) * 16
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=cuda)
    dsum = torch.randn(nt, sp, d, generator=gen, device=cuda)
    dsum[:, s:] = 0.0                                  # pad token rows, as the op makes them
    dsum = dsum.reshape(nt * sp, d)
    r_idx = (lay.tile_senders, edge_slot_valid(lay, mask.to(cuda)), lay.recv_ptr, lay.recv_slots)
    s_idx = (lay.snd_receivers, snd_slot_valid(lay, mask.to(cuda)), lay.snd_ptr, lay.snd_slots)
    kw = dict(s=s, sp=sp, num_heads=h, softmax=softmax)
    w = [t.to(cuda) for t in params(2, d)]
    deg = torch.bincount(g.receivers[mask], minlength=nt).to(cuda, torch.float32)
    invdeg = torch.where(deg > 0, 1.0 / deg.clamp_min(1.0), torch.zeros_like(deg))
    b16 = qkv.to(torch.bfloat16)
    x16 = b16[:, :d].contiguous()
    w16 = [t.to(torch.bfloat16).contiguous() for t in w]
    qdm16 = torch.cat([b16[:, :d], dsum.to(torch.bfloat16)], 1)
    x32 = qkv[:, :d].contiguous()
    cases = {
        "k1 bf16": (lambda: eaf.edge_attention_sums(b16[:, :d], b16[:, d:], *r_idx, **kw),
                    lambda: eaf.edge_attention_sums_plain(b16[:, :d], b16[:, d:], *r_idx, **kw),
                    BF16_LIMIT),
        "k1 mxu": (lambda: eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], *r_idx, **kw,
                                                   mxu_bf16=True),
                   lambda: eaf.edge_attention_sums_plain(qkv[:, :d], qkv[:, d:], *r_idx, **kw,
                                                         mxu_bf16=True), BF16_LIMIT),
        "k2 bf16": (lambda: eaf.edge_attention_layer(x16, *w16, invdeg, *r_idx, **kw),
                    lambda: eaf.edge_attention_layer_plain(x16, *w16, invdeg, *r_idx, **kw),
                    BF16_OUT_LIMIT),
        "k2 mxu": (lambda: eaf.edge_attention_layer(x32, *w, invdeg, *r_idx, **kw,
                                                    mxu_bf16=True),
                   lambda: eaf.edge_attention_layer_plain(x32, *w, invdeg, *r_idx, **kw,
                                                          mxu_bf16=True), BF16_LIMIT),
        "k3 bf16": (lambda: bwd.edge_attention_bwd_dq(b16[:, :d], b16[:, d:], qdm16[:, d:],
                                                      *r_idx, **kw),
                    lambda: bwd.edge_attention_bwd_dq_plain(b16[:, :d], b16[:, d:],
                                                            qdm16[:, d:], *r_idx, **kw),
                    BF16_LIMIT),
        "k4 bf16": (lambda: bwd.edge_attention_bwd_dkv(qdm16, b16[:, d:], *s_idx, **kw),
                    lambda: bwd.edge_attention_bwd_dkv_plain(qdm16, b16[:, d:], *s_idx, **kw),
                    BF16_LIMIT),
    }
    before = eaf.body_launch_counts()
    for name, (run, plain, limit) in cases.items():
        got, again, ref = run(), run(), plain()
        torch.cuda.synchronize()
        close_to_largest(got, ref, limit)
        assert torch.equal(got, again), name
        assert got.dtype == (torch.bfloat16 if name == "k2 bf16" else torch.float32), name
        assert (got.view(nt, sp, -1)[:, s:] == 0).all(), name
    after = eaf.body_launch_counts()
    for k, n in (("edge_attention_sums", 4), ("edge_attention_layer", 4),
                 ("edge_attention_bwd_dq", 2), ("edge_attention_bwd_dkv", 2)):
        assert after[k] == dict(before[k], tc_bf16=before[k]["tc_bf16"] + n), k


# K1's, K3's and K4's bodies at 48 < S <= 64: (library, info entry point)
# by body and rows
WIDE_INFO = {("k1", "tc"): ("edge_attention_tc", "ampnet_edge_attention_sums_info"),
             ("k1", "tc_bf16"): ("edge_attention_tc_bf16", "ampnet_edge_attention_sums_bf16_info"),
             ("k1", "mxu"): ("edge_attention_tc_bf16", "ampnet_edge_attention_sums_mxu_info"),
             ("k3", "tc"): ("edge_attention_bwd_dq_tc", "ampnet_edge_attention_bwd_dq_info"),
             ("k3", "tc_bf16"): ("edge_attention_bwd_dq_tc_bf16",
                                 "ampnet_edge_attention_bwd_dq_bf16_info"),
             ("k4", "tc"): ("edge_attention_bwd_tc", "ampnet_edge_attention_bwd_dkv_info"),
             ("k4", "tc_bf16"): ("edge_attention_bwd_tc_bf16",
                                 "ampnet_edge_attention_bwd_dkv_bf16_info")}
WIDE_WRAPPERS = {"k1": "edge_attention_sums", "k3": "edge_attention_bwd_dq",
                 "k4": "edge_attention_bwd_dkv"}


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s", [49, 56, 64])
@pytest.mark.parametrize("d,h", [(128, 4), (128, 8)])
@pytest.mark.parametrize("kernel", ["k1", "k3", "k4"])
def test_k1_k4_wide_bodies_match_plain_on_card(cuda, kernel, s, d, h, softmax):
    """K1, K3 and K4 at 48 < S <= 64 (one block per node and head), picked
    by the route: 'tc' on f32 rows against the plain version within 1e-4
    of the largest entry, 'tc_bf16' on bf16 rows (K1 also on f32 rows under
    mxu_bf16) within one bf16 step; each launched twice and equal bit for
    bit, pad token rows and the rows of a node of degree 0 exactly 0, every
    launch on the named body; the instantiation spills nothing and keeps at
    least two blocks on an SM. K3 also with more K|V rows than query rows
    (the partitioned path's shape: the senders' rows after as many foreign
    ones), bit for bit what it gives on the rows alone."""
    g, mask = graph(0, first_sender=1)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    nt = lay.recv_ptr.numel() - 1
    sp = -(-s // 16) * 16
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=cuda)
    dsum = torch.randn(nt, sp, d, generator=gen, device=cuda)
    dsum[:, s:] = 0.0                                  # pad token rows, as the op makes them
    dsum = dsum.reshape(nt * sp, d)
    qdm = torch.cat([qkv[:, :d], dsum], 1)
    b16, qdm16 = qkv.to(torch.bfloat16), qdm.to(torch.bfloat16)
    r_idx = (lay.tile_senders, edge_slot_valid(lay, mask.to(cuda)), lay.recv_ptr, lay.recv_slots)
    s_idx = (lay.snd_receivers, snd_slot_valid(lay, mask.to(cuda)), lay.snd_ptr, lay.snd_slots)
    far_idx = (lay.tile_senders + nt, *r_idx[1:])
    kv_far = torch.cat([torch.randn(nt * sp, 2 * d, generator=gen, device=cuda), qkv[:, d:]])
    kw = dict(s=s, sp=sp, num_heads=h, softmax=softmax)
    # name: (run, plain, limit, body)
    cases = {
        ("k1", "tc"): (lambda: eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], *r_idx, **kw),
                       lambda: eaf.edge_attention_sums_plain(qkv[:, :d], qkv[:, d:], *r_idx,
                                                             **kw), 1e-4, "tc"),
        ("k1", "tc_bf16"): (
            lambda: eaf.edge_attention_sums(b16[:, :d], b16[:, d:], *r_idx, **kw),
            lambda: eaf.edge_attention_sums_plain(b16[:, :d], b16[:, d:], *r_idx, **kw),
            BF16_LIMIT, "tc_bf16"),
        ("k1", "mxu"): (
            lambda: eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], *r_idx, **kw, mxu_bf16=True),
            lambda: eaf.edge_attention_sums_plain(qkv[:, :d], qkv[:, d:], *r_idx, **kw,
                                                  mxu_bf16=True), BF16_LIMIT, "tc_bf16"),
        ("k3", "tc"): (
            lambda: bwd.edge_attention_bwd_dq(qkv[:, :d], qkv[:, d:], dsum, *r_idx, **kw),
            lambda: bwd.edge_attention_bwd_dq_plain(qkv[:, :d], qkv[:, d:], dsum, *r_idx, **kw),
            1e-4, "tc"),
        ("k3", "tc_bf16"): (
            lambda: bwd.edge_attention_bwd_dq(b16[:, :d], b16[:, d:], qdm16[:, d:], *r_idx, **kw),
            lambda: bwd.edge_attention_bwd_dq_plain(b16[:, :d], b16[:, d:], qdm16[:, d:],
                                                    *r_idx, **kw), BF16_LIMIT, "tc_bf16"),
        ("k4", "tc"): (lambda: bwd.edge_attention_bwd_dkv(qdm, qkv[:, d:], *s_idx, **kw),
                       lambda: bwd.edge_attention_bwd_dkv_plain(qdm, qkv[:, d:], *s_idx, **kw),
                       1e-4, "tc"),
        ("k4", "tc_bf16"): (
            lambda: bwd.edge_attention_bwd_dkv(qdm16, b16[:, d:], *s_idx, **kw),
            lambda: bwd.edge_attention_bwd_dkv_plain(qdm16, b16[:, d:], *s_idx, **kw),
            BF16_LIMIT, "tc_bf16"),
    }
    wrapper = WIDE_WRAPPERS[kernel]
    for name, (run, plain, limit, body) in cases.items():
        if name[0] != kernel:
            continue
        eaf.reset_launch_counts()
        got, again = run(), run()
        torch.cuda.synchronize()
        assert eaf.body_launch_counts()[wrapper] == {**dict.fromkeys(launch.BODIES, 0),
                                                     body: 2}, name
        ref = plain()
        close_to_largest(got, ref, limit)
        assert torch.equal(got, again), name
        assert (got.view(nt, sp, -1)[:, s:] == 0).all(), name
        # degree 0: node 39 never receives, node 0 never sends (K4's rows)
        assert (got.view(nt, sp, -1)[0 if kernel == "k4" else 39] == 0).all(), name
        info = launch.kernel_info(*WIDE_INFO[name], nt, s, d, h)
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2, (name, info)
        assert info["threads"] == 128 and info["grid"] % h == 0, (name, info)
        if kernel == "k3":
            rows = (qkv, dsum) if body == "tc" else (b16, qdm16[:, d:])
            far = kv_far.to(rows[0].dtype)
            got_far = bwd.edge_attention_bwd_dq(rows[0][:, :d], far, rows[1], *far_idx, **kw)
            close_to_largest(got_far, bwd.edge_attention_bwd_dq_plain(
                rows[0][:, :d], far, rows[1], *far_idx, **kw), limit)
            assert torch.equal(got_far, got), name


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,d,h", [(40, 128, 4), (20, 128, 4), (4, 16, 2)])
def test_bf16_route_bodies_match_plain_on_card(cuda, s, d, h, softmax):
    """K5 (bf16 rows), K6 (bf16 rows; f32 rows under mxu_bf16), K7 (bf16 x
    and weights; f32 under mxu_bf16) and K9 (bf16 rows) on their bf16 body
    against their plain versions, every launch on tc_bf16. K5 (no atomics)
    also launched twice and equal bit for bit, its stream held row by row on
    the walked slots (rows of dropped slots written as 0); K6, K7 and K9 sum
    with f32 atomics, so only within the bf16 limit."""
    g, mask = graph(0, first_sender=1)
    lay = compute_layout(g, tile_nodes=16, sender_layout=False).to(cuda)
    nt = lay.recv_ptr.numel() - 1
    t, emax = lay.tile_senders.shape
    sp = -(-s // 16) * 16
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=cuda)
    dsum = torch.randn(nt, sp, d, generator=gen, device=cuda)
    dsum[:, s:] = 0.0                                  # pad token rows, as the op makes them
    b16 = qkv.to(torch.bfloat16)
    d16 = dsum.reshape(nt * sp, d).to(torch.bfloat16)
    valid = edge_slot_valid(lay, mask.to(cuda))
    r_idx = (lay.tile_senders, valid, lay.recv_ptr, lay.recv_slots)
    slots = (lay.tile_senders, lay.tile_recv, valid)
    kw = dict(s=s, sp=sp, num_heads=h, softmax=softmax)
    mm = dict(kw, tile_nodes=16)
    w = [t_.to(cuda) for t_ in params(2, d)]
    w16 = [t_.to(torch.bfloat16).contiguous() for t_ in w]
    deg = torch.bincount(g.receivers[mask], minlength=nt).to(cuda, torch.float32)
    invdeg = torch.where(deg > 0, 1.0 / deg.clamp_min(1.0), torch.zeros_like(deg))
    x16, x32 = b16[:, :d].contiguous(), qkv[:, :d].contiguous()
    group = 8 if emax % 8 == 0 else 1
    before = eaf.body_launch_counts()

    dq, stream = sb.edge_attention_bwd_stream(b16[:, :d], b16[:, d:], d16, *r_idx, **kw)
    dq2, stream2 = sb.edge_attention_bwd_stream(b16[:, :d], b16[:, d:], d16, *r_idx, **kw)
    dq_ref, stream_ref = sb.edge_attention_bwd_stream_plain(b16[:, :d], b16[:, d:], d16,
                                                            *r_idx, **kw)
    torch.cuda.synchronize()
    assert dq.dtype == stream.dtype == torch.float32
    assert torch.equal(dq, dq2)
    close_to_largest(dq, dq_ref, BF16_LIMIT)
    walked = lay.recv_slots.long()
    rows = stream.view(t * emax, sp, 2 * d)[walked]
    assert torch.equal(rows, stream2.view(t * emax, sp, 2 * d)[walked])
    ref_rows = stream_ref.view(t * emax, sp, 2 * d)[walked]
    for half in (slice(0, d), slice(d, 2 * d)):
        close_to_largest(rows[..., half], ref_rows[..., half], BF16_LIMIT)
    assert (rows[:, s:] == 0).all()
    assert (rows[valid.view(-1)[walked] == 0] == 0).all()

    cases = {
        "k6 bf16": (lambda: eav.edge_attention_sums_mm(b16[:, :d], b16[:, d:], *slots,
                                                       lay.tile_counts, **mm),
                    lambda: eav.edge_attention_sums_mm_plain(
                        b16[:, :d], b16[:, d:], *slots, lay.tile_counts, **mm,
                        group=eav.MM_GROUP), BF16_LIMIT, torch.float32),
        "k6 mxu": (lambda: eav.edge_attention_sums_mm(qkv[:, :d], qkv[:, d:], *slots,
                                                      lay.tile_counts, **mm, mxu_bf16=True),
                   lambda: eav.edge_attention_sums_mm_plain(
                       qkv[:, :d], qkv[:, d:], *slots, lay.tile_counts, **mm,
                       group=eav.MM_GROUP, mxu_bf16=True), BF16_LIMIT, torch.float32),
        "k7 bf16": (lambda: eav.edge_attention_layer_mm(x16, *w16, invdeg, *slots,
                                                        lay.tile_counts, **mm),
                    lambda: eav.edge_attention_layer_mm_plain(
                        x16, *w16, invdeg, *slots, lay.tile_counts, **mm,
                        group=eav.MM_GROUP), BF16_OUT_LIMIT, torch.bfloat16),
        "k7 mxu": (lambda: eav.edge_attention_layer_mm(x32, *w, invdeg, *slots,
                                                       lay.tile_counts, **mm, mxu_bf16=True),
                   lambda: eav.edge_attention_layer_mm_plain(
                       x32, *w, invdeg, *slots, lay.tile_counts, **mm, group=eav.MM_GROUP,
                       mxu_bf16=True), BF16_LIMIT, torch.float32),
        "k9 bf16": (lambda: eav.edge_attention_sums_v1(b16[:, :d], b16[:, d:], *slots, **mm,
                                                       group=group),
                    lambda: eav.edge_attention_sums_v1_plain(b16[:, :d], b16[:, d:], *slots,
                                                             **mm, group=group),
                    BF16_LIMIT, torch.float32),
    }
    for name, (run, plain, limit, dtype) in cases.items():
        got, ref = run(), plain()
        torch.cuda.synchronize()
        assert got.dtype == ref.dtype == dtype, name
        close_to_largest(got, ref, limit)
        assert (got.view(nt, sp, -1)[:, s:] == 0).all(), name
        assert (got.view(nt, sp, -1)[39] == 0).all(), name      # degree 0
    after = eaf.body_launch_counts()
    for k, n in (("edge_attention_bwd_stream", 2), ("edge_attention_sums_mm", 2),
                 ("edge_attention_layer_mm", 2), ("edge_attention_sums_v1", 1)):
        assert after[k] == dict(before[k], tc_bf16=before[k]["tc_bf16"] + n), k


# (S, D, H) beyond the bf16 tensor-core bodies' range: a seventh key tile,
# 24 warps, bf16 rows of 200 bytes (D=100: no 16-byte copies), path J's S=64,
# and S=96 (every working set in device memory). K1, K3 and K4 take S=49
# and S=64 on 'tc_bf16'.
SIMT_BF16_SHAPES = [(49, 128, 4), (40, 128, 8), (20, 100, 4), (64, 128, 4), (96, 128, 4)]


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,d,h", SIMT_BF16_SHAPES)
def test_simt_bf16_bodies_match_plain_on_card(cuda, s, d, h, softmax):
    """Every kernel's 'simt_bf16' body, picked by the route itself beyond the
    tensor cores' range: K1, K2, K6 and K7 on bf16 rows and on f32 rows
    under mxu_bf16, K3, K4, K5, K8 and K9 on bf16 rows, against their plain
    versions within one bf16 step of the largest entry (K2 and K7's bf16
    outputs two); the bodies without atomics launched twice and equal bit
    for bit; pad token rows and a receiver of degree 0 exactly 0; the
    launches counted by body, the device-memory ones where
    launch.simt_smem_bytes says the working set does not fit."""
    g, mask = graph(0, first_sender=1)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    ck = compute_chunked_layout(g, tile_nodes=16, chunk_edges=8).to(cuda)
    nt = lay.recv_ptr.numel() - 1
    t, emax = lay.tile_senders.shape
    sp = -(-s // 16) * 16
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=cuda)
    dsum = torch.randn(nt, sp, d, generator=gen, device=cuda)
    dsum[:, s:] = 0.0                                  # pad token rows, as the op makes them
    b16 = qkv.to(torch.bfloat16)
    d16 = dsum.reshape(nt * sp, d).to(torch.bfloat16)
    qdm16 = torch.cat([b16[:, :d], d16], 1)
    valid = edge_slot_valid(lay, mask.to(cuda))
    r_idx = (lay.tile_senders, valid, lay.recv_ptr, lay.recv_slots)
    s_idx = (lay.snd_receivers, snd_slot_valid(lay, mask.to(cuda)), lay.snd_ptr, lay.snd_slots)
    slots = (lay.tile_senders, lay.tile_recv, valid)
    chunks = (ck.senders, chunk_slot_valid(ck, mask.to(cuda)), ck.chunk_start, ck.chunk_count)
    kw = dict(s=s, sp=sp, num_heads=h, softmax=softmax)
    mm = dict(kw, tile_nodes=16)
    w = [t_.to(cuda) for t_ in params(2, d)]
    w16 = [t_.to(torch.bfloat16).contiguous() for t_ in w]
    deg = torch.bincount(g.receivers[mask], minlength=nt).to(cuda, torch.float32)
    invdeg = torch.where(deg > 0, 1.0 / deg.clamp_min(1.0), torch.zeros_like(deg))
    x16, x32 = b16[:, :d].contiguous(), qkv[:, :d].contiguous()
    group = 8 if emax % 8 == 0 else 1
    f32, bf = torch.float32, torch.bfloat16
    # name: (kernel, run, plain, limit, output type, repeats bit for bit)
    cases = {
        "k1 bf16": ("edge_attention_sums",
                    lambda: eaf.edge_attention_sums(b16[:, :d], b16[:, d:], *r_idx, **kw),
                    lambda: eaf.edge_attention_sums_plain(b16[:, :d], b16[:, d:], *r_idx, **kw),
                    BF16_LIMIT, f32, True),
        "k1 mxu": ("edge_attention_sums",
                   lambda: eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], *r_idx, **kw,
                                                   mxu_bf16=True),
                   lambda: eaf.edge_attention_sums_plain(qkv[:, :d], qkv[:, d:], *r_idx, **kw,
                                                         mxu_bf16=True), BF16_LIMIT, f32, True),
        "k2 bf16": ("edge_attention_layer",
                    lambda: eaf.edge_attention_layer(x16, *w16, invdeg, *r_idx, **kw),
                    lambda: eaf.edge_attention_layer_plain(x16, *w16, invdeg, *r_idx, **kw),
                    BF16_OUT_LIMIT, bf, True),
        "k2 mxu": ("edge_attention_layer",
                   lambda: eaf.edge_attention_layer(x32, *w, invdeg, *r_idx, **kw,
                                                    mxu_bf16=True),
                   lambda: eaf.edge_attention_layer_plain(x32, *w, invdeg, *r_idx, **kw,
                                                          mxu_bf16=True), BF16_LIMIT, f32, True),
        "k3 bf16": ("edge_attention_bwd_dq",
                    lambda: bwd.edge_attention_bwd_dq(b16[:, :d], b16[:, d:], d16, *r_idx, **kw),
                    lambda: bwd.edge_attention_bwd_dq_plain(b16[:, :d], b16[:, d:], d16, *r_idx,
                                                            **kw), BF16_LIMIT, f32, True),
        "k4 bf16": ("edge_attention_bwd_dkv",
                    lambda: bwd.edge_attention_bwd_dkv(qdm16, b16[:, d:], *s_idx, **kw),
                    lambda: bwd.edge_attention_bwd_dkv_plain(qdm16, b16[:, d:], *s_idx, **kw),
                    BF16_LIMIT, f32, True),
        "k5 bf16": ("edge_attention_bwd_stream",
                    lambda: sb.edge_attention_bwd_stream(b16[:, :d], b16[:, d:], d16, *r_idx,
                                                         **kw)[0],
                    lambda: sb.edge_attention_bwd_stream_plain(b16[:, :d], b16[:, d:], d16,
                                                               *r_idx, **kw)[0],
                    BF16_LIMIT, f32, True),
        "k6 bf16": ("edge_attention_sums_mm",
                    lambda: eav.edge_attention_sums_mm(b16[:, :d], b16[:, d:], *slots,
                                                       lay.tile_counts, **mm),
                    lambda: eav.edge_attention_sums_mm_plain(
                        b16[:, :d], b16[:, d:], *slots, lay.tile_counts, **mm,
                        group=eav.MM_GROUP), BF16_LIMIT, f32, False),
        "k6 mxu": ("edge_attention_sums_mm",
                   lambda: eav.edge_attention_sums_mm(qkv[:, :d], qkv[:, d:], *slots,
                                                      lay.tile_counts, **mm, mxu_bf16=True),
                   lambda: eav.edge_attention_sums_mm_plain(
                       qkv[:, :d], qkv[:, d:], *slots, lay.tile_counts, **mm,
                       group=eav.MM_GROUP, mxu_bf16=True), BF16_LIMIT, f32, False),
        "k7 bf16": ("edge_attention_layer_mm",
                    lambda: eav.edge_attention_layer_mm(x16, *w16, invdeg, *slots,
                                                        lay.tile_counts, **mm),
                    lambda: eav.edge_attention_layer_mm_plain(
                        x16, *w16, invdeg, *slots, lay.tile_counts, **mm,
                        group=eav.MM_GROUP), BF16_OUT_LIMIT, bf, False),
        "k7 mxu": ("edge_attention_layer_mm",
                   lambda: eav.edge_attention_layer_mm(x32, *w, invdeg, *slots,
                                                       lay.tile_counts, **mm, mxu_bf16=True),
                   lambda: eav.edge_attention_layer_mm_plain(
                       x32, *w, invdeg, *slots, lay.tile_counts, **mm, group=eav.MM_GROUP,
                       mxu_bf16=True), BF16_LIMIT, f32, False),
        "k8 bf16": ("edge_attention_sums_chunked",
                    lambda: eav.edge_attention_sums_chunked(b16[:, :d], b16[:, d:], *chunks,
                                                            **kw, chunk=8),
                    lambda: eav.edge_attention_sums_chunked_plain(b16[:, :d], b16[:, d:],
                                                                  *chunks, **kw, chunk=8),
                    BF16_LIMIT, f32, True),
        "k9 bf16": ("edge_attention_sums_v1",
                    lambda: eav.edge_attention_sums_v1(b16[:, :d], b16[:, d:], *slots, **mm,
                                                       group=group),
                    lambda: eav.edge_attention_sums_v1_plain(b16[:, :d], b16[:, d:], *slots,
                                                             **mm, group=group),
                    BF16_LIMIT, f32, False),
    }
    if launch.tensor_core_range_error(s, d, h) is None:
        # f32 rows of D=100 take 16-byte copies: under mxu_bf16 the route is
        # 'tc_bf16' there (test_bf16_bodies_match_plain_on_card)
        cases = {k: v for k, v in cases.items() if not k.endswith("mxu")}

    def body_of(name, kernel):
        # K1, K3 and K4 take 48 < S <= 64 on 'tc_bf16' (test_k1_k4_wide_
        # bodies_match_plain_on_card), where K1's and K3's views of the q|k|v
        # rows take 16-byte copies (K1's f32 rows under mxu_bf16 at any D
        # here, bf16 rows at D=128); K4's packed [Q | dsum] rows take them at
        # D=100 too
        if launch.tensor_core_range_error(s, d, h, kernel) is not None:
            return "simt_bf16"
        if kernel == "edge_attention_bwd_dkv":
            return "tc_bf16"
        if kernel == "edge_attention_sums" and (name.endswith("mxu") or d % 8 == 0):
            return "tc_bf16"
        if kernel == "edge_attention_bwd_dq" and d % 8 == 0:
            return "tc_bf16"
        return "simt_bf16"

    for name, (kernel, run, plain, limit, dtype, repeats) in cases.items():
        eaf.reset_launch_counts()
        got = run()
        again = run() if repeats else None
        torch.cuda.synchronize()
        counts, memory = eaf.body_launch_counts()[kernel], eaf.device_memory_launch_counts()
        ref = plain()
        assert got.dtype == ref.dtype == dtype, name
        close_to_largest(got, ref, limit)
        if repeats:
            assert torch.equal(got, again), name
        if kernel != "edge_attention_bwd_stream":
            assert (got.view(nt, sp, -1)[:, s:] == 0).all(), name
            # degree 0: node 39 never receives, node 0 never sends (K4's rows)
            zero = 0 if kernel == "edge_attention_bwd_dkv" else 39
            assert (got.view(nt, sp, -1)[zero] == 0).all(), name
        body = body_of(name, kernel)
        assert counts == {**dict.fromkeys(launch.BODIES, 0), body: 1 + repeats}, (name, counts)
        # the working set in device memory where it does not fit a block's
        # shared memory (K7's attention launch counts as K6's)
        attention = "edge_attention_sums_mm" if kernel == "edge_attention_layer_mm" else kernel
        part = (eav._mm_group("simt_bf16", s, d, h, None) if attention == "edge_attention_sums_mm"
                else eav._chunk_piece(s, d, h, 8, None) if kernel == "edge_attention_sums_chunked"
                else 0)
        in_memory = body == "simt_bf16" and launch.simt_smem_bytes(
            attention, s, d, h, part) > launch.MAX_SMEM
        assert bool(memory.get(attention)) == in_memory, (name, memory)


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("s,chunk", [(40, 8), (20, 8), (40, 3), (48, 8)])
def test_chunked_bf16_tensor_core_body_matches_plain_on_card(cuda, s, chunk, softmax):
    """K8's 'tc_bf16' body on bf16 rows (runtime mask, partial chunks)
    against its plain version and its 'simt_bf16' body within one bf16 step
    of the largest entry; f32 sums; pad token rows and a receiver of degree
    0 exactly 0; a second launch repeats the first bit for bit."""
    d, h = 128, 4
    q, kv, chunks, kw, _ = chunked_inputs(cuda, s, d, h, softmax, chunk)
    sp = -(-s // 16) * 16
    nt = chunks[2].numel()
    rows = torch.nn.functional.pad(torch.cat([q, kv], 1).view(nt, kw["sp"], 3 * d),
                                   (0, 0, 0, sp - kw["sp"])).reshape(nt * sp, 3 * d)
    b16 = rows.to(torch.bfloat16)
    kw = dict(kw, sp=sp)
    eaf.reset_launch_counts()
    got = eav.edge_attention_sums_chunked(b16[:, :d], b16[:, d:], *chunks, **kw, chunk=chunk)
    again = eav.edge_attention_sums_chunked(b16[:, :d], b16[:, d:], *chunks, **kw, chunk=chunk)
    simt = eav.edge_attention_sums_chunked(b16[:, :d], b16[:, d:], *chunks, **kw, chunk=chunk,
                                           body="simt_bf16")
    ref = eav.edge_attention_sums_chunked_plain(b16[:, :d], b16[:, d:], *chunks, **kw,
                                                chunk=chunk)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, again)
    for other in (ref, simt):
        close_to_largest(got, other, BF16_LIMIT)
    assert (got.reshape(nt, sp, d)[39] == 0).all()
    assert (got.reshape(nt, sp, d)[:, s:] == 0).all()
    assert eaf.body_launch_counts()["edge_attention_sums_chunked"] == dict(
        tc=0, simt=0, tc_bf16=2, simt_bf16=1)


def test_bf16_refusals_on_card(cuda):
    """bf16 runs at every shape the f32 path takes: beyond the tensor cores'
    range the default route runs bf16 rows (and f32 rows under mxu_bf16) on
    'simt_bf16', and K8 takes bf16 rows. The refusals that remain are the
    named bodies that do not take the call ('tc_bf16' beyond the range,
    'tc' or 'simt' named for bf16 rows, 'tc_bf16' or 'simt_bf16' named on
    f32 rows without mxu_bf16, where K3-K5 and K9 never take it) and mixed
    row types; they launch nothing."""
    g, mask = graph(0, first_sender=1)
    lay = compute_layout(g, tile_nodes=16).to(cuda)
    nt = lay.recv_ptr.numel() - 1
    d = 128
    r_idx = (lay.tile_senders, lay.tile_valid, lay.recv_ptr, lay.recv_slots)
    s_idx = (lay.snd_receivers, lay.snd_valid, lay.snd_ptr, lay.snd_slots)
    gen = torch.Generator(device=cuda).manual_seed(3)
    q65 = torch.randn(nt * 80, 3 * d, generator=gen, device=cuda).to(torch.bfloat16)
    q40 = torch.randn(nt * 48, 3 * d, generator=gen, device=cuda).to(torch.bfloat16)
    kw65 = dict(s=65, sp=80, num_heads=4, softmax=True)  # beyond every tensor-core body
    kw40 = dict(s=40, sp=48, num_heads=4, softmax=True)
    slots = (lay.tile_senders, lay.tile_recv, lay.tile_valid)
    ck = compute_chunked_layout(g, tile_nodes=16, chunk_edges=8).to(cuda)
    chunks = (ck.senders, ck.valid, ck.chunk_start, ck.chunk_count)
    # what used to raise runs: S=65 on the CUDA cores in bf16, K8 on bf16 rows
    eaf.reset_launch_counts()
    runs = {
        "k1": (lambda: eaf.edge_attention_sums(q65[:, :d], q65[:, d:], *r_idx, **kw65),
               lambda: eaf.edge_attention_sums_plain(q65[:, :d], q65[:, d:], *r_idx, **kw65)),
        "k4": (lambda: bwd.edge_attention_bwd_dkv(q65[:, : 2 * d], q65[:, d:], *s_idx, **kw65),
               lambda: bwd.edge_attention_bwd_dkv_plain(q65[:, : 2 * d], q65[:, d:], *s_idx,
                                                        **kw65)),
        "k5": (lambda: sb.edge_attention_bwd_stream(q65[:, :d], q65[:, d:], q65[:, :d], *r_idx,
                                                    **kw65)[0],
               lambda: sb.edge_attention_bwd_stream_plain(q65[:, :d], q65[:, d:], q65[:, :d],
                                                          *r_idx, **kw65)[0]),
        "k6": (lambda: eav.edge_attention_sums_mm(q65[:, :d], q65[:, d:], *slots,
                                                  lay.tile_counts, **kw65, tile_nodes=16),
               lambda: eav.edge_attention_sums_mm_plain(q65[:, :d], q65[:, d:], *slots,
                                                        lay.tile_counts, **kw65, tile_nodes=16,
                                                        group=eav.MM_GROUP)),
        "k8": (lambda: eav.edge_attention_sums_chunked(q40[:, :d], q40[:, d:], *chunks, **kw40,
                                                       chunk=8),
               lambda: eav.edge_attention_sums_chunked_plain(q40[:, :d], q40[:, d:], *chunks,
                                                             **kw40, chunk=8)),
    }
    for name, (run, plain) in runs.items():
        close_to_largest(run(), plain(), BF16_LIMIT)
    bodies = eaf.body_launch_counts()
    assert all(bodies[k]["simt_bf16"] == 1 for k in (
        "edge_attention_sums", "edge_attention_bwd_dkv", "edge_attention_bwd_stream",
        "edge_attention_sums_mm")), bodies
    assert bodies["edge_attention_sums_chunked"]["tc_bf16"] == 1, bodies
    before = eaf.body_launch_counts()
    with pytest.raises(ValueError, match="beyond it bf16 runs on 'simt_bf16'"):
        eaf.edge_attention_sums(q65[:, :d], q65[:, d:], *r_idx, **kw65, body="tc_bf16")
    with pytest.raises(ValueError, match="beyond it bf16 runs on 'simt_bf16'"):
        eav.edge_attention_sums_chunked(q65[:, :d], q65[:, d:], *chunks, **kw65, chunk=8,
                                        body="tc_bf16")
    f40 = q40.float()
    with pytest.raises(ValueError, match="float32 or bfloat16 rows of one type"):
        bwd.edge_attention_bwd_dq(q40[:, :d], f40[:, d:], q40[:, :d], *r_idx, **kw40)
    with pytest.raises(ValueError, match="float32 or bfloat16 rows of one type"):
        sb.edge_attention_bwd_stream(q40[:, :d], f40[:, d:], q40[:, :d], *r_idx, **kw40)
    with pytest.raises(ValueError, match="tc_bf16"):
        eaf.edge_attention_sums(q40[:, :d], q40[:, d:], *r_idx, **kw40, body="tc")
    with pytest.raises(ValueError, match="tc_bf16"):
        eaf.edge_attention_sums(q65[:, :d], q65[:, d:], *r_idx, **kw65, body="simt")
    with pytest.raises(ValueError, match="tc_bf16"):
        eav.edge_attention_sums_v1(q40[:, :d], q40[:, d:], *slots, **kw40, tile_nodes=16,
                                   group=1, body="tc")
    # bf16 products of f32 rows take mxu_bf16 only, and reach K1, K2 and K6
    # only: a bf16 body named on f32 rows raises on every kernel
    f_qdm = torch.cat([f40[:, :d], f40[:, :d]], 1)
    for b in ("tc_bf16", "simt_bf16"):
        with pytest.raises(ValueError, match="'tc_bf16' body"):
            bwd.edge_attention_bwd_dq(f40[:, :d], f40[:, d:], f40[:, :d], *r_idx, **kw40,
                                      body=b)
        with pytest.raises(ValueError, match="'tc_bf16' body"):
            bwd.edge_attention_bwd_dkv(f_qdm, f40[:, d:], *s_idx, **kw40, body=b)
        with pytest.raises(ValueError, match="'tc_bf16' body"):
            sb.edge_attention_bwd_stream(f40[:, :d], f40[:, d:], f40[:, :d], *r_idx, **kw40,
                                         body=b)
        with pytest.raises(ValueError, match="'tc_bf16' body"):
            eav.edge_attention_sums_v1(f40[:, :d], f40[:, d:], *slots, **kw40, tile_nodes=16,
                                       group=1, body=b)
        with pytest.raises(ValueError, match="'tc_bf16' body"):
            eaf.edge_attention_sums(f40[:, :d], f40[:, d:], *r_idx, **kw40, body=b)
    with pytest.raises(ValueError, match="'tc_bf16' body"):
        eaf.edge_attention_sums(f40[:, :d], f40[:, d:], *r_idx, **kw40, body="tc",
                                mxu_bf16=True)
    assert eaf.body_launch_counts() == before


def test_bf16_model_captured_step_equals_eager(cuda):
    """A bf16 model (compute_dtype='bfloat16', f32 parameters): three
    captured training steps against three eager bodies from one state, bit
    for bit (K1, K3 and K4 use no atomics), every launch on tc_bf16; the
    parameters and Adam's state stay f32."""
    from ampnet_tpu_torch.train import create_train_state, make_optimizer, make_train_step
    from ampnet_tpu_torch.train.state import _train_step_body

    g, _ = graph(11)
    g = g.to(cuda)
    cfg = AMPGCNConfig(**{**CAPTURE_CFG, "compute_dtype": "bfloat16"})
    lay = compute_layout(g, tile_nodes=16)

    def make():
        model = AMPGCN(cfg, generator=torch.Generator().manual_seed(1), device=cuda)
        return create_train_state(model, make_optimizer(
            model.parameters(), 3e-3, weight_decay=1e-3, grad_clip=1.0), seed=4)

    eager, one = make(), make()
    body, step = _train_step_body(eager.model), make_train_step(one.model)
    eaf.reset_launch_counts()
    for _ in range(3):
        want, got = body(eager, g, lay)[1], step(one, g, lay)[1]
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert_same_state(one, eager)
    bodies = eaf.body_launch_counts()
    for k in ("edge_attention_sums", "edge_attention_bwd_dq", "edge_attention_bwd_dkv"):
        assert bodies[k] == dict(tc=0, simt=0, tc_bf16=12, simt_bf16=0), bodies
    assert all(p.dtype == torch.float32 for p in one.model.parameters())


@pytest.mark.parametrize("mode", ["bf16 model", "stream_bf16"])
def test_bf16_stream_backward_captured_step_equals_eager(cuda, monkeypatch, mode):
    """Path F in bf16: make_pallas_train_step on a layout without a sender
    side, a bf16 model or the f32 model under stream_bf16, three captured
    steps against three eager bodies from one state, bit for bit (K1, K5
    and pass B's sorted sum use no atomics); each step 2 K1 + 2 K5, all on
    tc_bf16; the parameters and Adam's state stay f32."""
    from ampnet_tpu_torch.train import create_train_state, make_optimizer
    from ampnet_tpu_torch.train.pallas_step import fused_forward, make_pallas_train_step
    from ampnet_tpu_torch.train.state import _train_step_body

    if mode == "stream_bf16":
        monkeypatch.setattr(eaf, "STREAM_BF16_DEFAULT", True)
    g, _ = graph(11)
    g = g.to(cuda)
    dtype = "bfloat16" if mode == "bf16 model" else "float32"
    cfg = AMPGCNConfig(**{**CAPTURE_CFG, "compute_dtype": dtype, "dropout_adj_rate": 0.0})
    lay = compute_layout(g, tile_nodes=16, sender_layout=False)

    def make():
        model = AMPGCN(cfg, generator=torch.Generator().manual_seed(1), device=cuda)
        return create_train_state(model, make_optimizer(
            model.parameters(), 3e-3, weight_decay=1e-3, grad_clip=1.0), seed=4)

    eager, one = make(), make()
    body = _train_step_body(eager.model, "full", forward=fused_forward(eager.model))
    step = make_pallas_train_step(one.model, loss_mode="full")
    eaf.reset_launch_counts()
    for _ in range(3):
        want, got = body(eager, g, lay)[1], step(one, g, lay)[1]
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert_same_state(one, eager)
    bodies = eaf.body_launch_counts()
    for k in ("edge_attention_sums", "edge_attention_bwd_stream"):
        assert bodies[k] == dict(tc=0, simt=0, tc_bf16=12, simt_bf16=0), bodies
    assert not any(sum(bodies[k].values()) for k in bodies
                   if k not in ("edge_attention_sums", "edge_attention_bwd_stream")), bodies
    assert all(p.dtype == torch.float32 for p in one.model.parameters())


@pytest.mark.parametrize("feature_repeats,downsample", [(5, True), (1, False)])
def test_xor_model_fused_matches_plain_on_card(cuda, feature_repeats, downsample):
    """The synthetic XOR recipe's model (get_model('AMPNet'), D=32, H=2,
    S=20; and the non-downsampled config, every feature a token) with
    use_pallas on a layout against the same weights on the plain path, on
    the card: logits of one draw and every gradient of the masked-mean NLL;
    the forward runs K1 and the backward K3 + K4 on the tensor cores."""
    from ampnet_tpu_torch.data.synthetic import get_duplicated_xor_graphs
    from ampnet_tpu_torch.models import get_model
    from ampnet_tpu_torch.train.losses import masked_mean_nll

    gt, _ = get_duplicated_xor_graphs(96, 32, 0.3, 10, feature_repeats, seed=0)
    nf = 2 * feature_repeats
    d = 32 if downsample else 16
    kw = dict(embedding_dim=d, num_heads=2, num_node_features=nf, num_sampled_vectors=20,
              output_dim=2, feat_emb_dim=d - 1, val_emb_dim=1, dropout_rate=0.0,
              dropout_adj_rate=0.0, downsample_feature_vectors=downsample,
              feature_repeats=feature_repeats)
    fused = get_model("AMPNet", use_pallas=True, device=cuda, **kw)
    plain = get_model("AMPNet", device=cuda, **kw)
    plain.load_state_dict(fused.state_dict())
    g = gt.to(cuda)
    layout = compute_layout(g).to(cuda)
    sidx = (torch.randint(0, nf, (g.x.shape[0], 20), generator=torch.Generator().manual_seed(0))
            .to(cuda) if downsample else None)
    out = {}
    eaf.reset_launch_counts()
    for name, model, lay in (("fused", fused, layout), ("plain", plain, None)):
        model.zero_grad(set_to_none=True)
        logits = model(g, deterministic=False, generator=torch.Generator(device=cuda),
                       sampled_idx=sidx, edge_layout=lay)
        masked_mean_nll(logits, g.y, g.train_mask & g.node_mask).backward()
        out[name] = (logits.detach(), {k: p.grad for k, p in model.named_parameters()})
    counts = eaf.launch_counts()
    assert counts["edge_attention_sums"] == 2 and counts["edge_attention_bwd_dq"] == 2
    assert counts["edge_attention_bwd_dkv"] == 2
    assert all(b == "tc" for k in eaf.body_launch_counts().values() for b, n in k.items() if n)
    torch.testing.assert_close(out["fused"][0], out["plain"][0], rtol=RTOL, atol=ATOL)
    for k, gp in out["plain"][1].items():
        torch.testing.assert_close(out["fused"][1][k], gp, rtol=RTOL,
                                   atol=ATOL * max(1.0, float(gp.abs().max())), msg=k)
