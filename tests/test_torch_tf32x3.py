"""Why the tensor-core kernels take three TF32 products per f32 product,
on the CPU.

The tensor-core kernels (csrc/edge_attention_tc.cuh for K1 and K2's
attention, csrc/projection_tc.cuh for K2's projection and K7's two
projections, csrc/edge_attention_bwd_dq_tc.cu for K3,
csrc/edge_attention_bwd_tc.cu for K4, csrc/edge_attention_bwd_stream_tc.cu
for K5, csrc/edge_attention_groups_tc.cu for K6 and K9,
csrc/edge_attention_chunked_tc.cu for K8, helpers in
csrc/mma_tf32.cuh) split each f32 operand x into TF32 parts
hi = rna(x), lo = rna(x - hi) and take a product as lo*hi + hi*lo + hi*hi.
Here that arithmetic is emulated in torch: TF32 rounding is round to nearest
(ties away from zero) at 10 mantissa bits, each TF32 product is exact (11 x
11 significant bits) and is added in f32, as mma.sync accumulates. Applied
to K1's per-receiver sums, K3's per-receiver dQ and K4's per-sender dK|dV
over 17 edges at S=40, to K6's and K9's sums of the same 17 edges in the
order their atomics take them (a register sum per run of the receiver's
slots in a group, the runs then added to the output one after another),
to K8's sum of the same edges in its slot order (three chunks of 8, the
last partial, one slot masked at run time),
to K5's per-edge rows dK_e | dV_e of the same 17 edges (the transposed
products over the receiver's queries), to K2's q|k|v projection of a
receiver's and its senders' token rows, to its out-projection of a
receiver's mean and to K7's, whose mean is a row scale of the sums taken
as the A fragment is built (D=128 and D=100, H=4), the 3-product scheme
stays within the tolerance at which
chip_smoke.py holds a kernel against its plain version (rtol = atol = 1e-4)
and within the card tests' (rtol 2e-4, atol 2e-5) of float64, and one TF32
product does not. Also: the shape and alignment rules the kernels' wrappers
apply before a launch.
"""
import numpy as np
import pytest
import torch

from ampnet_tpu_torch.ops.hopper.launch import (
    check_tensor_core,
    gathered_rows_error,
    tensor_core_range_error,
)

# chip_smoke.py's KERNEL_RTOL / KERNEL_ATOL, and the card tests' RTOL / ATOL
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4
CARD_RTOL, CARD_ATOL = 2e-4, 2e-5
S, H, DEGREE = 40, 4, 17


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: the f32 value rounded to 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b (f32) as the tensor cores take it: 1 product of the TF32 parts,
    or 3 of the split (lo*hi + hi*lo, then hi*hi), each exact and rounded
    to f32 as it is added."""
    def exact(x, y):
        return (x.double() @ y.double()).float()

    a_hi, b_hi = tf32(a), tf32(b)
    if products == 1:
        return exact(a_hi, b_hi)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (exact(a_lo, b_hi) + exact(a_hi, b_lo)) + exact(a_hi, b_hi)


def heads(x: torch.Tensor) -> torch.Tensor:
    """[..., S, D] -> [..., H, S, dh]."""
    return x.reshape(*x.shape[:-1], H, x.shape[-1] // H).transpose(-3, -2)


def inputs(d: int, seed: int = 0):
    """One node's own rows and its 17 peers' rows, normal as chip_smoke.py's."""
    rng = np.random.default_rng(seed)
    own = torch.from_numpy(rng.standard_normal((S, 2 * d)).astype(np.float32))
    peers = torch.from_numpy(rng.standard_normal((DEGREE, S, 2 * d)).astype(np.float32))
    return own, peers


def k1_sums(q, kv, mm):
    """K1 for one receiver: sum over edges of softmax(Q K^T / sqrt(dh)) V."""
    d = q.shape[-1]
    scale = 1.0 / (d // H) ** 0.5
    qh = heads(q) * scale
    acc = torch.zeros(H, S, d // H, dtype=q.dtype)
    for e in range(kv.shape[0]):
        kh, vh = heads(kv[e, :, :d]), heads(kv[e, :, d:])
        w = torch.softmax(mm(qh, kh.transpose(-1, -2)), dim=-1)
        acc = acc + mm(w, vh)
    return acc


# how K6 and K9 cut a receiver's 17 edges: its runs of consecutive live
# slots within a group (slots are in the graph's edge order, so a receiver
# recurs in several groups and several times in one)
RUNS = (3, 1, 5, 2, 1, 4, 1)


def edge_group_sums(q, kv, mm):
    """K6 / K9 for one receiver: per run of its slots in a group, K1's sum
    in the warp's registers; each run's sum then added to the (zeroed)
    output in f32, as the atomics add them."""
    assert sum(RUNS) == kv.shape[0]
    out, first = torch.zeros(H, S, q.shape[-1] // H, dtype=q.dtype), 0
    for run in RUNS:
        out = out + k1_sums(q, kv[first:first + run], mm)
        first += run
    return out


# K8's chunked layout of the receiver's 17 edges at C=8: three chunks, the
# last partial (slots 17-23 are padding, validity 0), and slot 5 masked at
# run time
CHUNK, CHUNK_MASKED = 8, 5


def k8_chunked(q, kv, mm):
    """K8 on the tensor cores for one receiver: its slots walked in order,
    chunk by chunk, the slots of validity 0 skipped, each live edge's
    message added to ONE register sum that runs across the chunks (the
    chunk is only an index, not a product)."""
    d = q.shape[-1]
    scale = 1.0 / (d // H) ** 0.5
    qh = heads(q) * scale
    acc = torch.zeros(H, S, d // H, dtype=q.dtype)
    slots = -(-kv.shape[0] // CHUNK) * CHUNK
    for chunk0 in range(0, slots, CHUNK):
        for slot in range(chunk0, chunk0 + CHUNK):
            if slot >= kv.shape[0] or slot == CHUNK_MASKED:
                continue
            kh, vh = heads(kv[slot, :, :d]), heads(kv[slot, :, d:])
            w = torch.softmax(mm(qh, kh.transpose(-1, -2)), dim=-1)
            acc = acc + mm(w, vh)
    return acc


def k4_dkv(kv, qdm, mm):
    """K4 for one sender: sum over edges of dK = dS^T Q / sqrt(dh) and dV =
    W^T dMsg, the scores taken keys-major as the kernel does."""
    d = kv.shape[-1] // 2
    scale = 1.0 / (d // H) ** 0.5
    kh, vh = heads(kv[:, :d]) * scale, heads(kv[:, d:])
    dk = torch.zeros(H, S, d // H, dtype=kv.dtype)
    dv = torch.zeros_like(dk)
    for e in range(qdm.shape[0]):
        qh, dmh = heads(qdm[e, :, :d]), heads(qdm[e, :, d:])
        w = torch.softmax(mm(kh, qh.transpose(-1, -2)), dim=-2)     # over keys
        dw = mm(vh, dmh.transpose(-1, -2))
        ds = w * (dw - (dw * w).sum(dim=-2, keepdim=True))
        dv = dv + mm(w, dmh)
        dk = dk + mm(ds, qh) * scale
    return torch.cat([dk, dv], dim=-1)


def k3_dq(qdm, kv, mm):
    """K3 for one receiver, its products in the kernel's order: per edge S =
    (Q / sqrt(dh)) K^T, dW = dMsg V^T, the softmax over keys and its
    backward, dQ += dS K; 1/sqrt(dh) applied once at the end."""
    d = qdm.shape[-1] // 2
    scale = 1.0 / (d // H) ** 0.5
    qh, dmh = heads(qdm[:, :d]) * scale, heads(qdm[:, d:])
    acc = torch.zeros(H, S, d // H, dtype=qdm.dtype)
    for e in range(kv.shape[0]):
        kh, vh = heads(kv[e, :, :d]), heads(kv[e, :, d:])
        w = torch.softmax(mm(qh, kh.transpose(-1, -2)), dim=-1)    # over keys
        dw = mm(dmh, vh.transpose(-1, -2))
        ds = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
        acc = acc + mm(ds, kh)
    return acc * scale


def layer_weights(d: int, dtype):
    """AMPConv's init (xavier w_qkv, kaiming-uniform w_out) with biases
    N(0, 0.1), as chip_smoke.py's K2 phase draws them."""
    rng = np.random.default_rng(2)
    bound = (6.0 / (4 * d)) ** 0.5
    ws = (rng.uniform(-bound, bound, (d, 3 * d)), rng.normal(0.0, 0.1, 3 * d),
          rng.uniform(-d ** -0.5, d ** -0.5, (d, d)), rng.normal(0.0, 0.1, d))
    return [torch.from_numpy(w.astype(np.float32)).to(dtype) for w in ws]


def k2_projection(own, peers, mm):
    """K2's first launch on a receiver's and its senders' token rows."""
    d = own.shape[-1] // 2
    w_qkv, b_qkv, _, _ = layer_weights(d, own.dtype)
    return mm(torch.cat([own[:, :d], peers[:, :, :d].reshape(-1, d)]), w_qkv) + b_qkv


def k2_out_projection(own, peers, mm):
    """K2's epilogue, mean @ w_out + b_out, for a receiver of in-degree 1
    (Cora's most common): its mean is one message, the largest input the
    out-projection gets (a mean over 17 edges is ~4x smaller, and one TF32
    product then misses only the card tests' atol). The mean itself is
    taken in float64, so that only the out-projection's arithmetic differs."""
    d = own.shape[-1] // 2
    _, _, w_out, b_out = layer_weights(d, own.dtype)
    mean = k1_sums(own[:, :d].double(), peers[:1].double(), torch.matmul).to(own.dtype)
    return mm(mean.transpose(0, 1).reshape(S, d), w_out) + b_out


def k5_stream(qdm, kv, mm):
    """K5's per-edge rows for one receiver's 17 edges, in the kernel's
    order: S = (Q / sqrt(dh)) K^T and dW = dMsg V^T, the softmax over keys
    and its backward, then the two transposed products over the receiver's
    queries, dV_e = W^T dMsg and dK_e = dS^T (Q / sqrt(dh)): [17, H, S, 2 dh]."""
    d = qdm.shape[-1] // 2
    scale = 1.0 / (d // H) ** 0.5
    qh, dmh = heads(qdm[:, :d]) * scale, heads(qdm[:, d:])
    out = []
    for e in range(kv.shape[0]):
        kh, vh = heads(kv[e, :, :d]), heads(kv[e, :, d:])
        w = torch.softmax(mm(qh, kh.transpose(-1, -2)), dim=-1)    # over keys
        dw = mm(dmh, vh.transpose(-1, -2))
        ds = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
        out.append(torch.cat([mm(ds.transpose(-1, -2), qh), mm(w.transpose(-1, -2), dmh)], -1))
    return torch.stack(out)


def k7_out_projection(own, peers, mm):
    """K7's last launch for a receiver of in-degree 1: its sum of messages
    (taken in float64, so that only this launch's arithmetic differs) is
    scaled by 1/degree in the working type as the A fragment is built, then
    @ w_out + b_out (a live row)."""
    d = own.shape[-1] // 2
    _, _, w_out, b_out = layer_weights(d, own.dtype)
    sums = k1_sums(own[:, :d].double(), peers[:1].double(), torch.matmul).to(own.dtype)
    invdeg = torch.tensor(1.0, dtype=own.dtype)
    return mm(sums.transpose(0, 1).reshape(S, d) * invdeg, w_out) + b_out


KERNELS = {
    "k1": lambda own, peers, mm: k1_sums(own[:, : own.shape[1] // 2], peers, mm),
    "k6_k9": lambda own, peers, mm: edge_group_sums(own[:, : own.shape[1] // 2], peers, mm),
    "k8_chunked": lambda own, peers, mm: k8_chunked(own[:, : own.shape[1] // 2], peers, mm),
    "k4": lambda own, peers, mm: k4_dkv(own, peers, mm),
    "k3": k3_dq,
    "k2_projection": k2_projection,
    "k2_out_projection": k2_out_projection,
    "k5_stream": k5_stream,
    "k7_out_projection": k7_out_projection,
}


def within(got, ref, rtol, atol) -> bool:
    return torch.allclose(got.double(), ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("d", [128, 100])
def test_three_tf32_products_hold_the_kernel_tolerance(kernel, d):
    own, peers = inputs(d)
    ref = KERNELS[kernel](own.double(), peers.double(), torch.matmul)
    got = KERNELS[kernel](own, peers, lambda a, b: matmul_tf32(a, b, 3))
    err = float((got.double() - ref).abs().max())
    assert within(got, ref, KERNEL_RTOL, KERNEL_ATOL), err
    assert within(got, ref, CARD_RTOL, CARD_ATOL), err


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("d", [128, 100])
def test_one_tf32_product_misses_the_kernel_tolerance(kernel, d):
    own, peers = inputs(d)
    ref = KERNELS[kernel](own.double(), peers.double(), torch.matmul)
    got = KERNELS[kernel](own, peers, lambda a, b: matmul_tf32(a, b, 1))
    assert not within(got, ref, KERNEL_RTOL, KERNEL_ATOL)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 1.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)                # ties away from zero
    # hi + lo carries 22 bits: the split loses at most ~2^-22 of x
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(1000).astype(np.float32))
    hi = tf32(v)
    lo = tf32(v - hi)
    assert float(((hi + lo - v).abs() / v.abs()).max()) < 2.0 ** -21


@pytest.mark.parametrize("s,d,h", [(4, 16, 2), (7, 100, 4), (20, 128, 4), (40, 128, 4),
                                   (48, 128, 4), (16, 256, 8), (32, 192, 6)])
def test_tensor_core_range_takes_the_repo_shapes(s, d, h):
    assert tensor_core_range_error(s, d, h) is None


@pytest.mark.parametrize("s,d,h,why", [
    (49, 128, 4, "S=49"),            # a seventh key tile
    (200, 128, 4, "S=200"),
    (40, 128, 2, "D/H"),             # dh = 64
    (40, 256, 8, "warps"),           # 8 heads x 3 query tiles
    (20, 192, 6, "warps"),           # 12 warps where S <= 24 allows 8
    (40, 100, 3, "multiple"),
])
def test_tensor_core_range_refuses_beyond_it(s, d, h, why):
    err = tensor_core_range_error(s, d, h)
    assert err is not None and why in err


def test_gathered_rows_must_be_16_byte_copies():
    assert gathered_rows_error("kv_rows", 4096 + 512, 384, 256) is None
    assert gathered_rows_error("kv_rows", 4096 + 400, 300, 200) is None   # D=100 view
    assert "kv_rows" in gathered_rows_error("kv_rows", 4096 + 4, 384, 256)
    assert gathered_rows_error("kv_rows", 4096, 386, 256) is not None
    assert gathered_rows_error("kv_rows", 4096, 388, 254) is not None     # odd D


def test_check_tensor_core_raises_on_views_it_cannot_gather():
    qkv = torch.zeros(16, 3 * 100 + 4)
    check_tensor_core("k1", 7, 100, 4, ("kv_rows", qkv[:, 100:300]))
    with pytest.raises(ValueError, match="16-byte"):
        check_tensor_core("k1", 7, 100, 4, ("kv_rows", qkv[:, 101:301]))
    with pytest.raises(ValueError, match="16-byte"):
        check_tensor_core("k1", 7, 100, 4, ("kv_rows", torch.zeros(16, 302)[:, :200]))
    with pytest.raises(ValueError, match="range"):
        check_tensor_core("k1", 96, 128, 4, ("kv_rows", qkv[:, :256]))


def test_ptxas_report_reads_registers_and_spills_per_instantiation():
    from ampnet_tpu_torch.ops.hopper.build import parse_ptxas

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114sums_tc_kernelILi5EEEvPKfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114sums_tc_kernelILi5EEEvPKfi
    16 bytes stack frame, 12 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114sums_tc_kernelILi3EEEvPKfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114sums_tc_kernelILi3EEEvPKfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 74 registers, used 1 barriers
"""
    assert parse_ptxas(log) == {5: dict(regs=80, spill_stores=12, spill_loads=28),
                                3: dict(regs=74, spill_stores=0, spill_loads=0)}
    plain = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120projection_tc_kernelEPKfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120projection_tc_kernelEPKfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
"""
    assert parse_ptxas(plain + log)["_ZN12_GLOBAL__N_120projection_tc_kernelEPKfi"] == \
        dict(regs=96, spill_stores=0, spill_loads=0)
    assert parse_ptxas(plain + log)[5]["regs"] == 80
