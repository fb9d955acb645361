"""What every kernel wrapper of the port shares: the ctypes entry points of
the libraries ``build.py`` makes, the current stream, and the checks a
wrapper runs before it hands pointers to a kernel (device, type, shape,
contiguity, shared memory). A check raises; nothing here falls back."""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

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
