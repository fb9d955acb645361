"""The port's CUDA kernels on the card against their plain versions, and
the fused path on the card against the plain torch path on the CPU.

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
from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
from ampnet_tpu_torch.ops.hopper.format import compute_layout, edge_slot_valid

RTOL, ATOL = 2e-4, 2e-5
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def graph(seed, n=40, e=160, f=12):
    """Node n-1 is never a receiver; every 7th live edge is masked at run
    time."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, f)) < 0.4).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 1, e)])
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
