"""What every kernel wrapper of the port shares: the ctypes entry points of
the libraries ``build.py`` makes, the current stream, and the checks a
wrapper runs before it hands pointers to a kernel (device, type, shape,
contiguity, shared memory). A check raises; nothing here falls back."""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

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


def check_f32_rows(name: str, t: torch.Tensor, device, rows: int, cols: int) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got {t.dtype} on {t.device}")
    if t.dim() != 2 or tuple(t.shape) != (rows, cols) or t.stride(1) != 1:
        raise ValueError(f"{name}: expected [{rows}, {cols}] rows with unit column "
                         f"stride, got {tuple(t.shape)} strides {t.stride()}")


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


def check_smem(need: int, what: str) -> None:
    if need > MAX_SMEM:
        raise ValueError(f"{what} needs {need} B of shared memory per block "
                         f"(> {MAX_SMEM})")


# The range the tensor-core kernels (K1 csrc/edge_attention_tc.cu, K4
# csrc/edge_attention_bwd_tc.cu) are instantiated for: S in key tiles of 8
# (at most 6), a head in k-steps of 8 columns (at most 4), one warp per
# (head, 16-row tile), at most 12 warps (8 up to S=24, where K4 caps its
# registers for two blocks of 256 threads per SM). Within it a block's
# shared memory stays under the 227 KB it may have (201 KB for K4 at S=48).
TC_MAX_S, TC_MAX_DH = 48, 32


def tc_max_warps(s: int) -> int:
    return 8 if s <= 24 else 12


def tensor_core_range_error(s: int, d: int, num_heads: int) -> Optional[str]:
    """Why the tensor-core kernels do not take (S, D, H), or None."""
    if d % num_heads:
        return f"D={d} is not a multiple of num_heads={num_heads}"
    warps = num_heads * -(-s // 16)
    if not (1 <= s <= TC_MAX_S and d // num_heads <= TC_MAX_DH and warps <= tc_max_warps(s)):
        return (f"S={s}, D={d}, H={num_heads} is beyond the tensor-core kernels' "
                f"instantiated range (S <= {TC_MAX_S}, D/H <= {TC_MAX_DH}, "
                f"H * ceil(S/16) <= {tc_max_warps(s)} warps at this S)")
    return None


def gathered_rows_error(name: str, data_ptr: int, row_stride: int, width: int) -> Optional[str]:
    """Why rows that a tensor-core kernel gathers with 16-byte cp.async (f32,
    ``width`` floats a row, ``row_stride`` floats apart from ``data_ptr``)
    cannot be taken, or None."""
    if data_ptr % 16 or row_stride % 4 or width % 4:
        return (f"{name}: the gathered rows must be 16-byte aligned (address "
                f"{data_ptr:#x}, row stride {row_stride} and width {width} floats "
                f"must be multiples of 16 bytes)")
    return None


def check_tensor_core(what: str, s: int, d: int, num_heads: int,
                      gathered: Tuple[str, torch.Tensor]) -> None:
    """Raise ValueError where a tensor-core kernel does not take the shape
    or the rows it gathers."""
    name, rows = gathered
    err = (tensor_core_range_error(s, d, num_heads)
           or gathered_rows_error(name, rows.data_ptr(), rows.stride(0), rows.shape[1]))
    if err:
        raise ValueError(f"{what}: {err}")


def kernel_info(lib_name: str, fn_name: str, num_nodes: int, s: int, d: int,
                num_heads: int) -> dict:
    """What a tensor-core kernel's launch at these shapes runs with (its
    ``*_info`` entry point): registers and local (spill) bytes per thread,
    blocks per SM, ring stages, grid, threads and shared memory per block."""
    lib, fn = entry(lib_name, fn_name, [I, I, I, I, P])
    info = (ctypes.c_int * 7)()
    build.check(lib, fn(num_nodes, s, d, num_heads, ctypes.addressof(info)), fn_name)
    keys = ("regs", "local_bytes", "blocks_per_sm", "stages", "grid", "threads", "smem_bytes")
    return dict(zip(keys, info))
