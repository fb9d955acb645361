"""What every kernel wrapper of the port shares: the ctypes entry points of
the libraries ``build.py`` makes, the current stream, the checks a wrapper
runs before it hands pointers to a kernel (device, type, shape, contiguity,
alignment), and the rule that picks a kernel's body.

K1-K9 each have four hand-written bodies. On f32 rows: one on the tensor
cores (``tc``, 3xTF32) within the range they are instantiated for, and one
on the CUDA cores (``simt``) beyond it, at any shape. With bf16 products
(bf16 rows, and for K1, K2's attention and K6 (and K7's attention, K6's
body) also f32 rows whose products the caller asks to round to bf16,
``mxu_bf16``): one on the tensor cores in bf16 products with f32 sums
(``tc_bf16``, ``mma.sync`` m16n8k16) within the same range, and one on the
CUDA cores (``simt_bf16``, f32 FMAs on bf16-rounded operands) beyond it, at
any shape. ``body`` picks from (S, D, H), the rows' type and whether the
gathered rows take 16-byte copies, before any launch. The CUDA-core bodies
keep their working set in f32, in shared memory where it fits a block and
in device memory beyond that (``simt_work``), whatever the rows' type. A
check raises; nothing here falls back after a failed launch."""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from ampnet_tpu_torch.ops.hopper import build

P, I = ctypes.c_void_p, ctypes.c_int

# per-block dynamic shared memory on Hopper (232,448 bytes)
MAX_SMEM = 227 * 1024


def entry(lib_name: str, fn_name: str, argtypes: Sequence, restype=ctypes.c_int):
    """(library, function) of csrc/<lib_name>.cu with its C signature set."""
    lib = build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return lib, fn


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_rows(name: str, t: torch.Tensor, device, rows: int, cols: int,
               dtype: torch.dtype = torch.float32) -> None:
    """Rows of ``dtype`` on ``device``, [rows, cols], unit column stride."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got {t.dtype} on {t.device}")
    if t.dim() != 2 or tuple(t.shape) != (rows, cols) or t.stride(1) != 1:
        raise ValueError(f"{name}: expected [{rows}, {cols}] rows with unit column "
                         f"stride, got {tuple(t.shape)} strides {t.stride()}")


def check_node_rows(name: str, t: torch.Tensor, device, sp: int, cols: int,
                    dtype: torch.dtype = torch.float32) -> None:
    """check_rows for the gathered side of a kernel: whole nodes of ``sp``
    rows, as many as ``t`` holds (the edge-partitioned path's K|V rows
    outnumber its receivers)."""
    if t.dim() != 2 or not t.shape[0] or t.shape[0] % sp:
        raise ValueError(f"{name}: expected a positive multiple of sp={sp} rows, "
                         f"got {tuple(t.shape)}")
    check_rows(name, t, device, t.shape[0], cols, dtype)


def check_same_dtype(*named: Tuple[str, torch.Tensor]) -> torch.dtype:
    """The one row type (f32 or bf16) of a kernel's row arguments."""
    dt = named[0][1].dtype
    if dt not in (torch.float32, torch.bfloat16) or any(t.dtype != dt for _, t in named):
        raise ValueError("expected float32 or bfloat16 rows of one type, got "
                         + ", ".join(f"{n} {t.dtype}" for n, t in named))
    return dt


def check_index(name: str, t: torch.Tensor, device, numel: Optional[int] = None) -> None:
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous int32 on {device}, "
                         f"got {t.dtype} on {t.device}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: expected {numel} elements, got {t.numel()}")


def check_walk(device, peer_ids, valid, ptr, slots, names) -> None:
    """The four index arrays of a per-node edge walk: [T, EMAX] peer ids and
    validity over the layout's slots, the CSR pointer and the flat slots."""
    check_index(names[0], peer_ids, device)
    check_index(names[1], valid, device, peer_ids.numel())
    check_index(names[2], ptr, device)
    check_index(names[3], slots, device)


# The range the tensor-core kernels (K1 csrc/edge_attention_tc.cu, K2
# csrc/edge_attention_layer_tc.cu, K3 csrc/edge_attention_bwd_dq_tc.cu, K4
# csrc/edge_attention_bwd_tc.cu, K5 csrc/edge_attention_bwd_stream_tc.cu, K6
# and K9 csrc/edge_attention_groups_tc.cu, K8
# csrc/edge_attention_chunked_tc.cu) are instantiated for: S in key
# tiles of 8 (at most 6), a head in k-steps of 8 columns (at most 4), one
# warp per (head, 16-row tile), at most 12 warps (8 up to S=24, where K3-K5
# cap their registers for two blocks of 256 threads per SM). Within it a
# block's shared memory stays under the 227 KB it may have (201 KB for K4
# and 225 KB for K5 at S=48).
TC_MAX_S, TC_MAX_DH = 48, 32
# K1, K3 and K4 (WIDE_KERNELS) also take 48 < S <= WIDE_MAX_S (path J's
# S=64): one block per (node, head), its 4 warps the head's 16-row tiles,
# gathering that head's columns alone, so dh must be whole 16-byte pieces of
# f32 and of bf16 (a multiple of 8); any H (mma_tf32.cuh, wide_shape_ok). K2
# and K5-K9 keep S <= 48: beyond it they run their CUDA-core bodies.
WIDE_KERNELS = ("edge_attention_sums", "edge_attention_bwd_dq", "edge_attention_bwd_dkv")
WIDE_MAX_S = 64


def tc_max_warps(s: int) -> int:
    return 8 if s <= 24 else 12


def tensor_core_range_error(s: int, d: int, num_heads: int,
                            kernel: Optional[str] = None) -> Optional[str]:
    """Why ``kernel``'s tensor-core bodies do not take (S, D, H), or None;
    without a kernel, the range every tensor-core kernel takes."""
    if d % num_heads:
        return f"D={d} is not a multiple of num_heads={num_heads}"
    dh = d // num_heads
    if kernel in WIDE_KERNELS and TC_MAX_S < s <= WIDE_MAX_S:
        if dh <= TC_MAX_DH and dh % 8 == 0:
            return None
        return (f"S={s}, D={d}, H={num_heads} is beyond {kernel}'s tensor-core range at "
                f"{TC_MAX_S} < S <= {WIDE_MAX_S} (one block per head: D/H <= {TC_MAX_DH} "
                f"and a multiple of 8)")
    warps = num_heads * -(-s // 16)
    if not (1 <= s <= TC_MAX_S and dh <= TC_MAX_DH and warps <= tc_max_warps(s)):
        return (f"S={s}, D={d}, H={num_heads} is beyond the tensor-core kernels' "
                f"instantiated range (S <= {TC_MAX_S}, D/H <= {TC_MAX_DH}, "
                f"H * ceil(S/16) <= {tc_max_warps(s)} warps at this S"
                + (f"; {kernel} also {TC_MAX_S} < S <= {WIDE_MAX_S}"
                   if kernel in WIDE_KERNELS else "") + ")")
    return None


def gathered_rows_error(name: str, data_ptr: int, row_stride: int, width: int,
                        itemsize: int = 4) -> Optional[str]:
    """Why rows that a tensor-core kernel gathers with 16-byte cp.async
    (``width`` values of ``itemsize`` bytes a row, ``row_stride`` values
    apart from ``data_ptr``: one copy takes 4 f32 or 8 bf16 values) cannot
    be taken, or None."""
    per_copy = 16 // itemsize
    if data_ptr % 16 or row_stride % per_copy or width % per_copy:
        return (f"{name}: the gathered rows must be 16-byte aligned (address "
                f"{data_ptr:#x}, row stride {row_stride} and width {width} values "
                f"of {itemsize} bytes must be multiples of 16 bytes)")
    return None


def _rows_error(gathered: Sequence[Tuple[str, torch.Tensor]]) -> Optional[str]:
    for name, rows in gathered:
        err = gathered_rows_error(name, rows.data_ptr(), rows.stride(0), rows.shape[1],
                                  rows.element_size())
        if err:
            return err
    return None


def check_tensor_core(what: str, s: int, d: int, num_heads: int,
                      *gathered: Tuple[str, torch.Tensor]) -> None:
    """Raise ValueError where a tensor-core kernel does not take the shape
    or the rows it copies in 16-byte pieces (``(name, rows)`` pairs)."""
    err = tensor_core_range_error(s, d, num_heads, what) or _rows_error(gathered)
    if err:
        raise ValueError(f"{what}: {err}")


# ---- the bodies of K1-K6, K8 and K9, and the rule between them

# the kernels with a tensor-core and a CUDA-core body. K7
# (edge_attention_layer_mm) runs K6's bodies in its attention launch, and
# its projection launches on the same body.
TENSOR_CORE_KERNELS = ("edge_attention_sums", "edge_attention_layer",
                       "edge_attention_bwd_dq", "edge_attention_bwd_dkv",
                       "edge_attention_bwd_stream", "edge_attention_sums_mm",
                       "edge_attention_sums_chunked", "edge_attention_sums_v1")
# the edge-group kernels: their blocks walk (tile, group) items, not nodes
GROUP_KERNELS = ("edge_attention_sums_mm", "edge_attention_sums_v1")
BODIES = ("tc", "simt", "tc_bf16", "simt_bf16")
# the bodies with bf16 products, and the CUDA-core ones (whose working set
# may be in device memory)
BF16_BODIES = ("tc_bf16", "simt_bf16")
SIMT_BODIES = ("simt", "simt_bf16")
# the kernels whose bf16 body also takes f32 rows and rounds their
# products' operands (``mxu_bf16``), where the JAX body honours the flag:
# K1, K2's attention launch, K6 (v2_mm) and with it K7's attention launch
# (v6_mm). K3-K5 and K9 (the v1 bodies) never take it; the wrappers do not
# ask for it on the 'dma' gather, whose JAX bodies (v4, v8) ignore it.
MXU_KERNELS = ("edge_attention_sums", "edge_attention_layer", "edge_attention_sums_mm")
# a CUDA-core body whose working set exceeds MAX_SMEM keeps it in device
# memory: one slice per resident block, at most this many blocks per SM and
# this many bytes in all
WORK_BLOCKS_PER_SM = 2
WORK_BYTES = 256 * 1024 * 1024


def simt_smem_bytes(kernel: str, s: int, d: int, num_heads: int, group: int = 0) -> int:
    """Working set per block of a kernel's CUDA-core body ('simt' and
    'simt_bf16' alike: both keep it in f32): the
    ``smem_floats`` of csrc/edge_attention.cu (K1, and K2's attention
    launch), of csrc/edge_attention_bwd.cu (K3, K4, K5), of
    csrc/edge_attention_groups.cu (K6 with its buffer of ``group`` messages,
    K9) and of csrc/edge_attention_chunked.cu (K8 at a piece of ``group``
    edges, at least 1), in bytes. The libraries' ``*_smem_bytes`` entry
    points give the same numbers (a card test holds the two together)."""
    if kernel not in TENSOR_CORE_KERNELS:
        raise ValueError(f"{kernel} has no CUDA-core body of this family")
    s2, s4 = -(-s // 2) * 2, -(-s // 4) * 4
    if kernel == "edge_attention_sums_chunked":
        if group < 1:
            raise ValueError(f"K8's piece must be at least 1, got {group}")
        floats = ((s2 + group * s4) * (d + 1) + (group + 1) * s * d
                  + num_heads * s4 * group * s)
    elif kernel in GROUP_KERNELS:
        buffered = group if kernel == "edge_attention_sums_mm" else 0
        floats = (s2 + s4) * (d + 1) + s * d * (1 + buffered) + num_heads * s4 * s
    elif kernel in ("edge_attention_sums", "edge_attention_layer"):
        floats = (s2 + s4) * (d + 1) + s * d * 2 + num_heads * s4 * s
    else:
        floats = ((2 * s2 + 2 * s4) * (d + 1) + 2 * num_heads * s4 * s4
                  + s * d * (2 if kernel == "edge_attention_bwd_dkv" else 1))
    return 4 * floats


def simt_work_blocks(kernel: str, s: int, d: int, num_heads: int, num_nodes: int,
                     sm_count: int, group: int = 0) -> int:
    """0 where the CUDA-core body's working set fits a block's shared
    memory; else the number of blocks that walk the ``num_nodes`` nodes (K6
    and K9: (tile, group) items), each with its slice of device memory.
    ``group``: K6's group, K8's piece (``simt_smem_bytes``)."""
    per_block = simt_smem_bytes(kernel, s, d, num_heads, group)
    if per_block <= MAX_SMEM:
        return 0
    return max(1, min(num_nodes, WORK_BLOCKS_PER_SM * sm_count, WORK_BYTES // per_block))


def simt_work(kernel: str, s: int, d: int, num_heads: int, num_nodes: int, device,
              group: int = 0):
    """(buffer, blocks) of a CUDA-core launch: (None, 0) for shared memory,
    else a device-memory buffer of ``blocks`` working sets. The caller keeps
    the buffer until the launch is queued and passes its pointer (0 for
    None) and ``blocks`` to the entry point."""
    blocks = simt_work_blocks(kernel, s, d, num_heads, num_nodes,
                              torch.cuda.get_device_properties(device).multi_processor_count,
                              group)
    if not blocks:
        return None, 0
    floats = simt_smem_bytes(kernel, s, d, num_heads, group) // 4
    return torch.empty(blocks * floats, dtype=torch.float32, device=device), blocks


def body(kernel: str, s: int, d: int, num_heads: int, rows_aligned: bool,
         bf16: bool = False) -> str:
    """The body a kernel runs at (S, D, H): the tensor cores within the
    kernel's instantiated range (``tensor_core_range_error``: S <= 48, and
    for K1, K3 and K4 S <= 64) where the gathered rows take 16-byte copies, else the
    CUDA cores; in bf16 products with ``bf16`` (bf16 rows, or products
    rounded to bf16: 'tc_bf16' or 'simt_bf16'), else in f32 ('tc', 3xTF32,
    or 'simt')."""
    if kernel not in TENSOR_CORE_KERNELS:
        raise ValueError(f"unknown kernel {kernel}")
    if d % num_heads:
        raise ValueError(f"D={d} is not a multiple of num_heads={num_heads}")
    tensor_cores = rows_aligned and tensor_core_range_error(s, d, num_heads, kernel) is None
    if bf16:
        return "tc_bf16" if tensor_cores else "simt_bf16"
    return "tc" if tensor_cores else "simt"


def f32_body(body_name: str) -> str:
    """The f32 body on the same cores: what a launch that mxu_bf16 does not
    reach (K2's and K7's projections of f32 rows) runs beside the bf16
    attention."""
    return {"tc_bf16": "tc", "simt_bf16": "simt"}.get(body_name, body_name)


def body_of(kernel: str, body_name: Optional[str], s: int, d: int, num_heads: int,
            *gathered: Tuple[str, torch.Tensor], mxu_bf16: bool = False) -> str:
    """The body a wrapper runs on the rows it was given: ``body_name`` where
    the caller names one (raises where that body does not take the call),
    else ``body``'s choice. bf16 products run on 'tc_bf16' or 'simt_bf16'
    and only there: bf16 rows, and f32 rows under ``mxu_bf16``
    (``MXU_KERNELS`` only); ``mxu_bf16`` is the one switch for f32 rows, so
    a named bf16 body without it raises, as does a named 'tc' or 'simt'
    with it. Beyond the tensor cores' range, or on rows the 16-byte copies
    cannot take, a named 'tc' or 'tc_bf16' raises; 'simt_bf16' takes any
    shape, as 'simt' does."""
    rows_bf16 = any(rows.dtype == torch.bfloat16 for _, rows in gathered)
    if mxu_bf16 and not rows_bf16 and kernel not in MXU_KERNELS:
        raise ValueError(f"{kernel}: mxu_bf16 reaches {MXU_KERNELS} only")
    bf16 = rows_bf16 or mxu_bf16
    if body_name is None:
        body_name = body(kernel, s, d, num_heads, _rows_error(gathered) is None, bf16)
    elif body_name not in BODIES:
        raise ValueError(f"{kernel}: body {body_name!r} is not one of {BODIES}")
    elif (body_name in BF16_BODIES) != bf16:
        raise ValueError(f"{kernel}: bf16 rows and mxu_bf16 run on the 'tc_bf16' body or "
                         f"on 'simt_bf16', f32 rows without mxu_bf16 on 'tc' or 'simt', "
                         f"not {body_name!r}")
    if body_name == "tc_bf16":
        err = tensor_core_range_error(s, d, num_heads, kernel) or _rows_error(gathered)
        if err:
            raise ValueError(f"{kernel}: {err}; beyond it bf16 runs on 'simt_bf16'")
    elif body_name == "tc":
        check_tensor_core(kernel, s, d, num_heads, *gathered)
    return body_name


def entry_of(kernel: str, table: dict, body_name: str, dtype: torch.dtype):
    """(library, entry point) of ``kernel``'s body on rows of ``dtype``,
    from its ``table`` keyed by (body, row type); raises where the body has
    no entry for that type. Every wrapper with a bf16 body takes its entry
    points here, after ``body_of``."""
    try:
        return table[(body_name, dtype)]
    except KeyError:
        raise ValueError(f"{kernel}: the {body_name!r} body has no entry point "
                         f"for {dtype} rows") from None


# launches of a CUDA-core body whose working set was in device memory, by
# kernel (K7's attention launch is K6's); cleared with the launch counts
device_memory_launches: Dict[str, int] = {}


def launch_body(kernel: str, body_name: str, lib_fn, args: Sequence, s: int, d: int,
                num_heads: int, num_nodes: int, device, group: int = 0) -> None:
    """One launch of a kernel's body through its entry point ``lib_fn``
    (library, function): ``args``, then for the CUDA-core body its working
    set in device memory (pointer, blocks; 0, 0 for shared memory), then
    the stream."""
    lib, fn = lib_fn
    if body_name in SIMT_BODIES:
        # freed on return, once the launch is queued: the stream orders its reuse
        work, blocks = simt_work(kernel, s, d, num_heads, num_nodes, device, group)
        args = (*args, 0 if work is None else work.data_ptr(), blocks)
        if work is not None:
            device_memory_launches[kernel] = device_memory_launches.get(kernel, 0) + 1
    build.check(lib, fn(*args, stream()), f"{kernel} ({body_name})")


def count_launch(wrapper, body_name: str) -> None:
    """One launch of ``wrapper``'s kernel, by the body that ran."""
    wrapper.launches += 1
    wrapper.body_launches[body_name] += 1


def kernel_info(lib_name: str, fn_name: str, num_nodes: int, s: int, d: int,
                num_heads: int) -> dict:
    """What a tensor-core kernel's launch over ``num_nodes`` nodes (K6, K9:
    items) at these shapes runs with (its ``*_info`` entry point): registers and local (spill) bytes per thread,
    blocks per SM, ring stages, grid, threads and shared memory per block."""
    lib, fn = entry(lib_name, fn_name, [I, I, I, I, P])
    info = (ctypes.c_int * 7)()
    build.check(lib, fn(num_nodes, s, d, num_heads, ctypes.addressof(info)), fn_name)
    keys = ("regs", "local_bytes", "blocks_per_sm", "stages", "grid", "threads", "smem_bytes")
    return dict(zip(keys, info))
