"""Which body each kernel of the fused op runs at a shape, on the CPU.

K1-K5, the edge-group sums K6 and K9 (and K7, on K6's rule) and the
receiver-chunked sums K8 each have a tensor-core body (within the range it
is instantiated for, on rows that take 16-byte copies)
and a CUDA-core body (beyond it, at any shape: its working set sits in
shared memory where it fits a block, in device memory beyond that). The rule (``launch.body``, ``launch.body_of``
on the rows a wrapper is given, ``launch.simt_work_blocks``) reads shapes,
addresses and strides only, so this file sees the decision the card makes.
AMPConv keeps the fused op at every shape: at shapes beyond shared memory
it is held against the JAX AMPGCN's XLA path with the same converted
parameters and the same injected ``sampled_idx`` (logits rtol 1e-4 / atol
1e-5; loss rtol 1e-5; gradients rtol 2e-4 with atol 2e-6 times the largest
entry, as ``tests/test_torch_train.py`` holds them: f32 sums in another
order)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
from ampnet_tpu.models import AMPGCN as JaxAMPGCN
from ampnet_tpu.train.losses import masked_mean_nll as jax_masked_mean_nll
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.hopper import launch
from ampnet_tpu_torch.ops.hopper.format import compute_layout
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train.losses import masked_mean_nll

K1, K2, K3, K4, K5 = ("edge_attention_sums", "edge_attention_layer", "edge_attention_bwd_dq",
                      "edge_attention_bwd_dkv", "edge_attention_bwd_stream")
K6, K8, K9 = "edge_attention_sums_mm", "edge_attention_sums_chunked", "edge_attention_sums_v1"
TC, SIMT = "tc", "simt"

# (S, D, H) -> the body of K1, K2, K3, K4 in the fused op
ROUTES = [
    ((40, 128, 4), (TC, TC, TC, TC)),            # the recommended recipe
    ((20, 128, 4), (TC, TC, TC, TC)),            # the reference recipe's S
    ((40, 100, 4), (TC, TC, TC, TC)),            # dh = 25, zero-padded in the head
    ((4, 16, 2), (TC, TC, TC, TC)),
    ((40, 128, 1), (SIMT, SIMT, SIMT, SIMT)),    # D/H = 128
    ((40, 128, 2), (SIMT, SIMT, SIMT, SIMT)),    # D/H = 64
    ((20, 128, 8), (SIMT, SIMT, SIMT, SIMT)),    # 16 warps where S <= 24 takes 8
    ((40, 128, 8), (SIMT, SIMT, SIMT, SIMT)),    # 24 warps; K4 at 225,920 B
    ((49, 128, 4), (TC, SIMT, TC, TC)),          # a seventh key tile: K1, K3, K4 a block per head
    ((64, 128, 4), (TC, SIMT, TC, TC)),          # path J's S=64
    ((64, 128, 8), (TC, SIMT, TC, TC)),          # dh = 16
    ((49, 100, 4), (SIMT, SIMT, SIMT, SIMT)),    # dh = 25: a head is no whole 16-byte piece
    ((65, 128, 4), (SIMT, SIMT, SIMT, SIMT)),    # beyond S=64; K4 at 352,816 B
    ((96, 128, 4), (SIMT, SIMT, SIMT, SIMT)),
    ((40, 3, 1), (SIMT, SIMT, SIMT, SIMT)),      # odd D: no 16-byte copies
    ((40, 6, 2), (SIMT, SIMT, SIMT, TC)),        # [Q | dMsg] rows of 12 floats copy, k|v at 6 not
]


def k5_to_k9_body(shape, want):
    """K5-K9 gather k|v rows as K3 does and keep the range up to S=48 (K3
    reaches S=64): K3's body there, the CUDA cores beyond it."""
    return want[2] if shape[0] <= launch.TC_MAX_S else SIMT


def op_rows(s, d):
    """The rows the fused op hands K1-K4: column views of one q|k|v buffer,
    token rows, the weights and packed [Q | dMsg] rows (CPU tensors of the
    same shapes, strides and offsets)."""
    rows = 8 * -(-s // 8) * 4
    qkv = torch.zeros(rows, 3 * d)
    x_rows, w_qkv = torch.zeros(rows, d), torch.zeros(d, 3 * d)
    qdm = torch.cat([qkv[:, :d], torch.zeros(rows, d)], dim=1)
    return {K1: [("kv_rows", qkv[:, d:])], K2: [("x_rows", x_rows), ("w_qkv", w_qkv)],
            K3: [("kv_rows", qkv[:, d:])], K4: [("qdm_rows", qdm)]}


@pytest.mark.parametrize("shape,want", ROUTES)
def test_fused_op_bodies_over_the_fault_list_and_the_repo_shapes(shape, want):
    gathered = op_rows(shape[0], shape[1])
    got = tuple(launch.body_of(k, None, *shape, *gathered[k]) for k in (K1, K2, K3, K4))
    assert got == want
    # K5 gathers the k|v rows K3 gathers, in K3's range up to S=48
    assert launch.body_of(K5, None, *shape, *gathered[K3]) == k5_to_k9_body(shape, want)


@pytest.mark.parametrize("shape,want", ROUTES)
def test_edge_group_bodies_follow_k1(shape, want):
    """K6 and K9 gather k|v rows as K1 and K3 do and are instantiated for
    the range of S <= 48 (K1's own up to S=48; K1, K3 and K4 reach S=64):
    the same body as K3 on the op's k|v view up to S=48, the CUDA cores
    beyond; K7's attention launch takes K6's body on its own q|k|v buffer."""
    s, d, _ = shape
    kv = op_rows(s, d)[K1]
    want_k6 = k5_to_k9_body(shape, want)
    assert launch.body_of(K6, None, *shape, *kv) == want_k6
    assert launch.body_of(K9, None, *shape, *kv) == want_k6
    own = torch.zeros(8, 3 * d)[:, d:]
    assert launch.body_of(K6, None, *shape, ("kv_rows", own)) == want_k6
    if s <= launch.TC_MAX_S:
        assert want[2] == want[0]


def test_edge_group_bodies_refuse_a_named_tensor_core_body_beyond_the_range():
    kv = torch.zeros(64, 3 * 128)[:, 128:]
    for kernel in (K6, K9, K8):
        assert launch.body_of(kernel, "tc", 40, 128, 4, ("kv_rows", kv)) == TC
        assert launch.body_of(kernel, "simt", 40, 128, 4, ("kv_rows", kv)) == SIMT
        with pytest.raises(ValueError, match="range"):
            launch.body_of(kernel, "tc", 49, 128, 4, ("kv_rows", kv))
        with pytest.raises(ValueError, match="warps"):
            launch.body_of(kernel, "tc", 40, 128, 8, ("kv_rows", kv))
        with pytest.raises(ValueError, match="16-byte"):
            launch.body_of(kernel, "tc", 40, 128, 4, ("kv_rows", torch.zeros(64, 385)[:, 129:]))


@pytest.mark.parametrize("shape,want", ROUTES)
def test_chunked_body_follows_k1(shape, want):
    """K8 gathers k|v rows as K1 does and is instantiated for K1's range
    up to S=48: K3's body (K1's up to S=48) on the op's k|v view at every
    shape of the fault list up to S=48, the CUDA cores beyond, and the
    CUDA-core body on rows that do not take 16-byte copies."""
    s, d, _ = shape
    assert launch.body_of(K8, None, *shape, *op_rows(s, d)[K1]) == k5_to_k9_body(shape, want)
    assert launch.body_of(K8, None, *shape, ("kv_rows", torch.zeros(8, 3 * d + 1)[:, 1:])) == SIMT


@pytest.mark.parametrize("shape,want", [
    ((40, 128, 4), TC), ((20, 128, 4), TC), ((48, 128, 4), TC), ((7, 100, 4), TC),
    ((40, 100, 4), TC),
    ((49, 128, 4), SIMT),     # a seventh key tile
    ((40, 128, 8), SIMT),     # 24 warps
    ((20, 128, 8), SIMT),     # 16 warps where S <= 24 takes 8
    ((40, 128, 2), SIMT),     # D/H = 64
    ((40, 3, 1), SIMT),       # odd D: no 16-byte copies
])
def test_stream_backward_takes_k3s_body(shape, want):
    """K5 (pass A of the stream backward) on the tensor cores within K3's
    range up to S=48, on the k|v view of the op's q|k|v buffer; its
    CUDA-core body beyond it; a named tensor-core body beyond it raises."""
    s, d, h = shape
    kv = op_rows(s, d)[K3]
    assert launch.body_of(K5, None, *shape, *kv) == want
    assert launch.body_of(K5, SIMT, *shape, *kv) == SIMT
    if want == SIMT:
        with pytest.raises(ValueError, match="range|16-byte"):
            launch.body_of(K5, TC, *shape, *kv)
    else:
        assert launch.body_of(K5, TC, *shape, *kv) == TC
        with pytest.raises(ValueError, match="16-byte"):
            launch.body_of(K5, TC, *shape, ("kv_rows", torch.zeros(8, 3 * d + 4)[:, d + 1: 3 * d + 1]))


def gemm_takes(a, lda, b, ldb, k, n) -> bool:
    """The tensor cores' tiled product (csrc/projection_tc.cuh,
    projection_tc_error): A and B 16-byte aligned, lda, ldb, K and N
    multiples of 4 floats."""
    return (a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
            and lda % 4 == 0 and ldb % 4 == 0 and k % 4 == 0 and n % 4 == 0)


@pytest.mark.parametrize("shape,want", [(shape, k5_to_k9_body(shape, want))
                                        for shape, want in ROUTES])
@pytest.mark.parametrize("x_view", ["own", "column_view", "offset_view"])
def test_layer_mm_tensor_core_choice_meets_the_gemm_alignment(shape, want, x_view):
    """K7 runs its three launches on one body; where that is the tensor
    cores, its projection (x_rows @ w_qkv into a fresh q|k|v buffer) and
    its out-projection (the fresh [rows, D] sums @ w_out) meet the tiled
    product's alignment. Token rows that are a view the 16-byte copies
    cannot take send K7 to the CUDA cores, where K6 alone would stay."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav

    s, d, h = shape
    rows = 8 * -(-s // 8) * 4
    wide = torch.zeros(rows, 2 * d + 4)
    x_rows = {"own": torch.zeros(rows, d), "column_view": wide[:, 4: d + 4],
              "offset_view": wide[:, 1: d + 1]}[x_view]
    w_qkv, w_out = torch.zeros(d, 3 * d), torch.zeros(d, d)
    qkv = torch.zeros(rows, 3 * d)
    body = eav.layer_mm_body(None, s, d, h, x_rows, w_qkv, w_out, qkv[:, d:])
    if x_view == "offset_view":
        assert body == SIMT
    else:
        assert body == want          # K6's body on the same k|v view
    if body == TC:
        sums = torch.zeros(rows, d)
        assert gemm_takes(x_rows, x_rows.stride(0), w_qkv, 3 * d, d, 3 * d)
        assert gemm_takes(sums, d, w_out, d, d, d)
        assert qkv.stride(0) % 2 == 0 and sums.stride(0) % 2 == 0   # 8-byte stores


@pytest.mark.parametrize("kernel", [K1, K2, K3, K4, K5])
def test_body_refuses_d_not_a_multiple_of_h(kernel):
    with pytest.raises(ValueError, match="multiple of num_heads"):
        launch.body(kernel, 40, 100, 3, rows_aligned=True)


@pytest.mark.parametrize("kernel,shape,nbytes", [
    (K3, (96, 128, 4), 542_208), (K1, (96, 128, 4), 344_832),
    (K4, (49, 128, 4), 241_968), (K1, (49, 128, 4), 143_576),
    (K4, (40, 128, 8), 225_920), (K1, (40, 128, 4), 107_840),
    (K4, (40, 128, 4), 174_720), (K2, (20, 128, 4), 4 * (40 * 129 + 5120 + 1600)),
    (K5, (40, 128, 4), 4 * (160 * 129 + 12800 + 5120)),
])
def test_simt_shared_memory_mirror_at_known_values(kernel, shape, nbytes):
    """The CUDA-core bodies' smem_floats (csrc/edge_attention.cu:54-57,
    csrc/edge_attention_bwd.cu:86-90), in bytes; MAX_SMEM is Hopper's 227 KB."""
    assert launch.simt_smem_bytes(kernel, *shape) == nbytes
    assert launch.MAX_SMEM == 232_448


@pytest.mark.parametrize("kernel,shape,group,nbytes", [
    (K6, (40, 128, 4), 4, 4 * (80 * 129 + 5 * 5120 + 6400)),   # 169,280: 4 messages
    (K6, (40, 128, 4), 1, 107_840),
    (K6, (40, 128, 4), 8, 251_200),                             # beyond shared memory
    (K6, (96, 128, 4), 1, 344_832),
    (K6, (49, 128, 4), 4, 218_840),
    (K6, (40, 128, 8), 4, 194_880),
    (K9, (40, 128, 4), 8, 87_360),                              # no buffer: group unused
    (K9, (96, 128, 4), 8, 295_680),
    (K6, (20, 128, 4), 4, 4 * (40 * 129 + 5 * 2560 + 1600)),
])
def test_edge_group_shared_memory_mirror_at_known_values(kernel, shape, group, nbytes):
    """The CUDA-core groups body's smem_floats (csrc/edge_attention_groups.cu),
    K6's buffer of ``group`` messages of S x D floats included."""
    assert launch.simt_smem_bytes(kernel, *shape, group) == nbytes


@pytest.mark.parametrize("shape,piece,nbytes", [
    ((40, 128, 4), 2, 174_560),     # the default piece at S=40: 2 of C=8's edges
    ((40, 128, 4), 3, 241_280),     # beyond shared memory
    ((20, 128, 4), 4, 4 * ((20 + 80) * 129 + 5 * 2560 + 4 * 20 * 80)),
    ((49, 128, 4), 1, 143_576),
    ((49, 128, 4), 2, 236_264),     # beyond shared memory: piece 1 at S=49
    ((73, 128, 4), 1, 240_920),     # beyond shared memory even at piece 1
    ((96, 128, 4), 1, 344_832),
])
def test_chunked_shared_memory_mirror_at_known_values(shape, piece, nbytes):
    """K8's CUDA-core smem_floats (csrc/edge_attention_chunked.cu), at a
    piece of ``piece`` edges: Q, ``piece`` edges' K and V, their scores and
    the accumulator."""
    assert launch.simt_smem_bytes(K8, *shape, piece) == nbytes
    with pytest.raises(ValueError, match="piece"):
        launch.simt_smem_bytes(K8, *shape, 0)


@pytest.mark.parametrize("shape,piece,blocks", [
    ((40, 128, 4), 2, 0), ((49, 128, 4), 1, 0), ((40, 128, 4), 8, 264),
    ((73, 128, 4), 1, 264), ((96, 128, 4), 1, 264), ((400, 128, 4), 1, 79),
])
def test_chunked_working_set_moves_to_device_memory(shape, piece, blocks):
    """K8's CUDA-core body in device memory where even its piece does not
    fit shared memory: two blocks per SM of 132, the 256 MiB cap."""
    assert launch.simt_work_blocks(K8, *shape, 2752, sm_count=132, group=piece) == blocks
    assert blocks * launch.simt_smem_bytes(K8, *shape, piece) <= launch.WORK_BYTES


@pytest.mark.parametrize("shape,piece", [((20, 128, 4), 4), ((40, 128, 4), 2), ((49, 128, 4), 1),
                                         ((73, 128, 4), 1), ((96, 128, 4), 1), ((40, 16, 2), 8)])
def test_chunked_default_piece_on_the_cuda_cores(shape, piece):
    """K8's piece where the caller names none: C=8 in the fewest equal
    pieces that fit shared memory, 1 where none fits (then in device
    memory); a named piece outside 1..C raises, one beyond shared memory
    does not."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav

    assert eav._chunk_piece(*shape, 8, None) == piece
    assert eav._chunk_piece(*shape, 8, 8) == 8
    for bad in (0, 9):
        with pytest.raises(ValueError, match="piece"):
            eav._chunk_piece(*shape, 8, bad)


@pytest.mark.parametrize("shape,group", [((40, 128, 4), 4), ((20, 128, 4), 4),
                                         ((49, 128, 4), 4), ((40, 128, 8), 4),
                                         ((96, 128, 4), 1), ((200, 16, 8), 1)])
def test_edge_group_default_group_on_the_cuda_cores(shape, group):
    """K6's CUDA-core body takes the largest group up to MM_GROUP that keeps
    its working set in shared memory, else 1 (then in device memory); the
    tensor cores take MM_GROUP; a named group beyond the buffer's 32 slots
    is refused on the CUDA cores only."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav

    assert eav._mm_group(SIMT, *shape, None) == group
    assert eav._mm_group(TC, *shape, None) == eav.MM_GROUP
    assert eav._mm_group(TC, *shape, 64) == 64
    with pytest.raises(ValueError, match="at most 32"):
        eav._mm_group(SIMT, *shape, 33)
    with pytest.raises(ValueError, match="at least 1"):
        eav._mm_group(TC, *shape, 0)


@pytest.mark.parametrize("kernel,shape,nodes,blocks", [
    (K4, (40, 128, 8), 2752, 0),        # 225,920 B: shared memory
    (K1, (49, 128, 4), 2752, 0),
    (K1, (96, 128, 4), 2752, 264),      # 344,832 B: two blocks per SM of 132
    (K4, (49, 128, 4), 2752, 264),
    (K3, (96, 128, 4), 100, 100),       # no more blocks than nodes
    (K5, (96, 128, 4), 2752, 264),
    (K2, (20, 1024, 1), 2752, 264),     # wide rows: 329,440 B
    (K4, (400, 128, 4), 2752, 42),      # 6.4 MB a block: the 256 MiB cap
    (K9, (40, 128, 4), 1584, 0),        # items: 11 tiles x 144 groups of 8
    (K9, (96, 128, 4), 1584, 264),
    (K6, (96, 128, 4), 12672, 264),     # group 1
])
def test_simt_working_set_moves_to_device_memory_beyond_shared_memory(
        kernel, shape, nodes, blocks):
    group = 1 if kernel == K6 else 0
    assert launch.simt_work_blocks(kernel, *shape, nodes, sm_count=132, group=group) == blocks
    per_block = launch.simt_smem_bytes(kernel, *shape, group)
    assert (blocks == 0) == (per_block <= launch.MAX_SMEM)
    assert blocks * per_block <= launch.WORK_BYTES


def test_body_takes_the_tensor_cores_only_on_aligned_rows():
    assert launch.body(K1, 40, 128, 4, rows_aligned=True) == TC
    assert launch.body(K1, 40, 128, 4, rows_aligned=False) == SIMT
    assert launch.body(K5, 40, 128, 4, rows_aligned=True) == TC
    assert launch.body(K5, 40, 128, 4, rows_aligned=False) == SIMT
    assert launch.body(K4, 96, 128, 4, rows_aligned=True) == SIMT
    assert launch.body(K6, 40, 128, 4, rows_aligned=True) == TC
    assert launch.body(K9, 40, 128, 4, rows_aligned=False) == SIMT
    assert launch.body(K8, 40, 128, 4, rows_aligned=True) == TC
    assert launch.body(K8, 40, 128, 4, rows_aligned=False) == SIMT


@pytest.mark.parametrize("bf16", [False, True])
def test_body_takes_k1_k3_and_k4_to_the_tensor_cores_at_s64(bf16):
    """Path J's S=64 at D=128, H=4: K1, K3 and K4 on their tensor-core
    bodies (one block per node and head), the others on the CUDA cores; the
    range error names the kernel's own limit."""
    tc, simt = ("tc_bf16", "simt_bf16") if bf16 else (TC, SIMT)
    for kernel, want in ((K1, tc), (K3, tc), (K4, tc), (K2, simt), (K5, simt), (K6, simt),
                         (K8, simt), (K9, simt)):
        assert launch.body(kernel, 64, 128, 4, rows_aligned=True, bf16=bf16) == want, kernel
    assert launch.tensor_core_range_error(64, 128, 4, K1) is None
    assert launch.tensor_core_range_error(64, 128, 4, K3) is None
    assert launch.tensor_core_range_error(49, 128, 8, K4) is None
    assert "S=64" in launch.tensor_core_range_error(64, 128, 4, K5)
    assert "S=64" in launch.tensor_core_range_error(64, 128, 4)
    assert "multiple of 8" in launch.tensor_core_range_error(64, 100, 4, K1)
    assert "S=65" in launch.tensor_core_range_error(65, 128, 4, K4)


def test_body_of_checks_a_named_body():
    qkv = torch.zeros(64, 3 * 128)
    assert launch.body_of(K1, "simt", 40, 128, 4, ("kv_rows", qkv[:, 128:])) == SIMT
    assert launch.body_of(K1, "tc", 49, 128, 4, ("kv_rows", qkv[:, 128:])) == TC
    with pytest.raises(ValueError, match="range"):
        launch.body_of(K1, "tc", 65, 128, 4, ("kv_rows", qkv[:, 128:]))
    with pytest.raises(ValueError, match="16-byte"):
        launch.body_of(K1, "tc", 40, 128, 4, ("kv_rows", qkv[:, 129:-1]))
    with pytest.raises(ValueError, match="is not one of"):
        launch.body_of(K1, "wgmma", 40, 128, 4, ("kv_rows", qkv[:, 128:]))


@pytest.mark.parametrize("kernel", [K1, K2, K3, K4, K5, K6, K9])
def test_bf16_products_take_one_switch(kernel):
    """bf16 products run on 'tc_bf16' and only there: on bf16 rows, and on
    f32 rows under mxu_bf16, which reaches K1, K2's attention and K6 (K7's
    attention) only: on K3-K5 and K9 it raises. A named 'tc_bf16' on f32
    rows without mxu_bf16 raises, as does a named f32 body on bf16 rows or
    under mxu_bf16. Beyond the tensor cores' range (S=65) they run on
    'simt_bf16', which the same switch holds: named on f32 rows without
    mxu_bf16 it raises."""
    f32 = ("kv_rows", torch.zeros(64, 3 * 128)[:, 128:])
    bf16 = ("kv_rows", torch.zeros(64, 3 * 128, dtype=torch.bfloat16)[:, 128:])
    shape = (40, 128, 4)
    assert launch.body_of(kernel, None, *shape, bf16) == "tc_bf16"
    assert launch.body_of(kernel, "tc_bf16", *shape, bf16) == "tc_bf16"
    assert launch.body_of(kernel, None, *shape, f32) == TC
    for named, rows in (("tc_bf16", f32), (TC, bf16), (SIMT, bf16)):
        with pytest.raises(ValueError, match="'tc_bf16' body"):
            launch.body_of(kernel, named, *shape, rows)
    beyond = (65, 128, 4)
    assert launch.body_of(kernel, None, *beyond, bf16) == "simt_bf16"
    assert launch.body_of(kernel, "simt_bf16", *shape, bf16) == "simt_bf16"
    with pytest.raises(ValueError, match="'tc_bf16' body"):
        launch.body_of(kernel, "simt_bf16", *shape, f32)
    if kernel in launch.MXU_KERNELS:
        assert launch.body_of(kernel, None, *shape, f32, mxu_bf16=True) == "tc_bf16"
        assert launch.body_of(kernel, "tc_bf16", *shape, f32, mxu_bf16=True) == "tc_bf16"
        with pytest.raises(ValueError, match="'tc_bf16' body"):
            launch.body_of(kernel, TC, *shape, f32, mxu_bf16=True)
        assert launch.body_of(kernel, None, *beyond, f32, mxu_bf16=True) == "simt_bf16"
        with pytest.raises(ValueError, match="'tc_bf16' body"):
            launch.body_of(kernel, SIMT, *beyond, f32, mxu_bf16=True)
    else:
        with pytest.raises(ValueError, match="mxu_bf16 reaches"):
            launch.body_of(kernel, None, *shape, f32, mxu_bf16=True)


@pytest.mark.parametrize("kernel", [K1, K2, K3, K4, K5, K6, K9, "q|k|v projection",
                                    "K7 out-projection"])
def test_entry_point_by_body_and_row_type(kernel):
    """The wrappers with a bf16 body (K1-K6, K9; K2's and K7's projection
    launches, K7's out-projection) take their entry point from (body, row
    type): the f32 bodies on f32 rows, 'tc_bf16' and 'simt_bf16' on bf16
    rows, and on f32 rows only where mxu_bf16 reaches (K1, K2's attention,
    K6); anything else raises before a pointer is handed over."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav

    table = {K1: eaf._SUMS, K2: eaf._LAYER_ATTENTION, K3: bwd._DQ, K4: bwd._DKV,
             K5: sb._BODIES, K6: eav._SUMS_MM, K9: eav._SUMS_V1,
             "q|k|v projection": eav._PROJECTION,
             "K7 out-projection": eav._LAYER_MM_OUT_PROJECTION}[kernel]
    f32, bf16 = torch.float32, torch.bfloat16
    assert {launch.entry_of(kernel, table, b, f32) for b in (TC, SIMT)} == {
        table[(TC, f32)], table[(SIMT, f32)]}
    assert launch.entry_of(kernel, table, "tc_bf16", bf16)[1].endswith("_bf16")
    assert launch.entry_of(kernel, table, "simt_bf16", bf16)[1].endswith("_bf16")
    for b in (TC, SIMT):
        with pytest.raises(ValueError, match="no entry point"):
            launch.entry_of(kernel, table, b, bf16)
    if kernel in launch.MXU_KERNELS:
        assert launch.entry_of(kernel, table, "tc_bf16", f32)[1].endswith("_mxu")
        assert launch.entry_of(kernel, table, "simt_bf16", f32)[1].endswith("_mxu")
    else:
        for b in launch.BF16_BODIES:
            with pytest.raises(ValueError, match="no entry point"):
                launch.entry_of(kernel, table, b, f32)


def test_chunked_sums_stay_f32_only():
    """K8 (no model path reaches it) takes bf16 rows as the JAX chunked body
    does, on its two bf16 bodies: 'tc_bf16' at the rule within the tensor
    cores' range, 'simt_bf16' beyond it; mxu_bf16 does not reach it (the
    JAX body has no such flag), and f32 rows keep their two bodies. Each
    body has its entry point by row type, f32 sums from either."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav

    f32 = ("kv_rows", torch.zeros(64, 3 * 128)[:, 128:])
    bf16 = ("kv_rows", torch.zeros(64, 3 * 128, dtype=torch.bfloat16)[:, 128:])
    assert K8 not in launch.MXU_KERNELS
    assert launch.body_of(K8, None, 40, 128, 4, f32) == TC
    for named, rows in ((None, bf16), ("tc_bf16", bf16)):
        assert launch.body_of(K8, named, 40, 128, 4, rows) == "tc_bf16"
    assert launch.body_of(K8, None, 96, 128, 4, bf16) == "simt_bf16"
    with pytest.raises(ValueError, match="mxu_bf16 reaches"):
        launch.body_of(K8, None, 40, 128, 4, f32, mxu_bf16=True)
    assert launch.entry_of(K8, eav._SUMS_CHUNKED, "tc_bf16", torch.bfloat16) == (
        "edge_attention_chunked_tc_bf16", "ampnet_edge_attention_sums_chunked_bf16")
    assert launch.entry_of(K8, eav._SUMS_CHUNKED, "tc", torch.float32)[1] == \
        "ampnet_edge_attention_sums_chunked"
    # every kernel of the family has its two bf16 bodies on bf16 rows
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    for table in (eaf._SUMS, eaf._LAYER_ATTENTION, bwd._DQ, bwd._DKV, sb._BODIES,
                  eav._SUMS_MM, eav._SUMS_V1, eav._SUMS_CHUNKED):
        assert {("tc_bf16", torch.bfloat16), ("simt_bf16", torch.bfloat16)} <= set(table)


def test_count_launch_splits_by_body():
    def wrapper():
        pass
    wrapper.launches, wrapper.body_launches = 0, dict.fromkeys(launch.BODIES, 0)
    for b in (TC, SIMT, TC, "tc_bf16", "simt_bf16"):
        launch.count_launch(wrapper, b)
    assert wrapper.launches == 5 and wrapper.body_launches == {TC: 2, SIMT: 1, "tc_bf16": 1,
                                                               "simt_bf16": 1}


# ---- AMPConv beyond shared memory: the fused op against the JAX XLA path

F = 24


def both_models(rng, d, h, s):
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
               dropout_adj_rate=0.0)
    stats = fit_scaler(x)
    jm = JaxAMPGCN(config=JaxConfig(**cfg), scaler_stats=stats)
    k = jax.random.PRNGKey(0)
    params = jm.init({"params": k, "sample": k, "dropout": k, "edges": k}, gj,
                     return_aux=False)["params"]
    tm = AMPGCN(AMPGCNConfig(**cfg, use_pallas=True), scaler_stats=stats, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    return jm, params, tm, gj, gt


@pytest.mark.parametrize("train,s", [(False, 96), (True, 64)])
def test_ampconv_beyond_shared_memory_matches_jax_xla(rng, train, s):
    """D=16, H=8: an eval at S=96 needs K1 or K2, whose CUDA-core body
    needs 320 KB a block; a training step at S=64 needs K3 and K4 (283 KB
    and 288 KB). The torch AMPConv keeps the fused op without a warning
    (on the card those bodies work in device memory); the JAX model runs
    its XLA path."""
    d, h = 16, 8
    kernels = (K3, K4) if train else (K1, K2)
    assert all(launch.simt_smem_bytes(k, s, d, h) > launch.MAX_SMEM for k in kernels)
    jm, params, tm, gj, gt = both_models(rng, d, h, s)
    idx = rng.integers(0, F, (16, s))
    layout = compute_layout(gt, tile_nodes=8)
    if not train:
        ref = jm.apply({"params": params}, gj, deterministic=True,
                       sampled_idx=jnp.asarray(idx), return_aux=False).logits
        with warnings.catch_warnings(), torch.no_grad():
            warnings.simplefilter("error")
            got = tm(gt, sampled_idx=torch.from_numpy(idx), edge_layout=layout)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
        return

    def loss_fn(p):
        k = jax.random.PRNGKey(1)
        out = jm.apply({"params": p}, gj, deterministic=False, return_aux=False,
                       sampled_idx=jnp.asarray(idx), rngs={"sample": k, "dropout": k, "edges": k})
        return jax_masked_mean_nll(out.logits, gj.y, gj.train_mask & gj.node_mask)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        logits = tm(gt, deterministic=False, sampled_idx=torch.from_numpy(idx),
                    edge_layout=layout)
    loss = masked_mean_nll(logits, gt.y, gt.train_mask & gt.node_mask)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    ref = flax_to_state_dict(jax.device_get(grads_j))
    for name, p in tm.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=2e-4,
                                   atol=2e-6 * max(1.0, np.abs(r).max()), err_msg=name)


@pytest.mark.parametrize("train,s,d,h", [(False, 65, 64, 4), (True, 40, 128, 8),
                                         (True, 20, 64, 1)])
def test_ampconv_stays_fused_where_a_body_takes_the_call(rng, train, s, d, h):
    """Beyond the tensor cores, within the CUDA-core bodies' shared memory,
    the layer keeps the fused op (its plain versions here): no warning."""
    assert launch.body(K1, s, d, h, rows_aligned=True) == SIMT
    assert launch.simt_smem_bytes(K1, s, d, h) <= launch.MAX_SMEM
    _, _, tm, _, gt = both_models(rng, d, h, s)
    idx = torch.from_numpy(rng.integers(0, F, (16, s)))
    layout = compute_layout(gt, tile_nodes=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with torch.set_grad_enabled(train):
            out = tm(gt, deterministic=not train, sampled_idx=idx, edge_layout=layout)
    assert torch.isfinite(out).all()
