"""Fused AMPConv edge attention on Hopper: the forward of the JAX
package's ``amp_edge_attention_pallas`` / ``_pallas_core_dynamic``
(``ampnet_tpu/ops/pallas/edge_attention_fused.py:1953-2098, 2430-2505``).

Two hand-written kernels (``csrc/``), each beside its plain torch version:

* ``edge_attention_sums`` (K1) — per-receiver SUM of per-edge multi-head
  attention messages over projected q / k|v rows. Counterpart of both
  ``_fused_kernel_vmem_v2`` ('vmem' gather) and ``_fused_kernel_vmem_v4``
  ('dma' gather): Hopper has no VMEM-resident/DMA split, K|V are read
  from device memory either way, so one kernel serves both modes.
* ``edge_attention_layer`` (K2) — the whole layer, counterpart of
  ``_fused_kernel_vmem_v6``: a projection launch (q|k|v for every row),
  then the K1 walk with the 1/degree fold and the out-projection and
  live-row bias in its epilogue.

``amp_edge_attention_fused`` chooses between them with the JAX package's
own predicates and constants (``_resolve_gather``, ``_v6_usable``), so both
packages take the same math path for the same config. Around K1 the glue
stays plain torch, as the JAX package leaves it to XLA: the QKV
projection, the mean, the out-projection.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. Each wrapper counts its launches in
``<wrapper>.launches``. The op is forward-only: autograd asking it for a
gradient raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ampnet_tpu_torch.ops.edge_attention import MHAParams, attention_core
from ampnet_tpu_torch.ops.hopper import build
from ampnet_tpu_torch.ops.hopper.format import DEFAULT_TILE_NODES
from ampnet_tpu_torch.ops.segment import segment_count

# The JAX package's dispatch constants (its env-var defaults), mirrored so
# the choice between K1 and K2 is the one the JAX package makes.
_VMEM_KV_BUDGET = 80 * 1024 * 1024
_VMEM_TOTAL_BUDGET = 96 * 1024 * 1024
_V6_VMEM_LIMIT = 120 * 1024 * 1024

# per-block dynamic shared memory on Hopper (232,448 bytes)
_MAX_SMEM = 227 * 1024


def _softmax_stack_bytes(group: int, sp: int) -> int:
    """JAX's estimate of the per-head softmax chain's lane-padded stack."""
    return 4 * group * sp * (-(-sp // 128) * 128) * 4


def _v6_fits(n_rows: int, d: int, itemsize: int, tile_rows: int,
             group_rows: int, sp: int) -> bool:
    resident = n_rows * 3 * d * itemsize
    weights = (3 * d * d + d * d + 4 * d) * itemsize
    per_tile = tile_rows * d * (2 * itemsize + 4)
    bufs = group_rows * 3 * d * itemsize
    stack = _softmax_stack_bytes(group_rows // sp, sp)
    return resident + weights + per_tile + bufs + stack + 2 * 1024 * 1024 <= _V6_VMEM_LIMIT


def _resolve_gather(gather: str, n_rows: int, d: int, itemsize: int,
                    tile_rows: int) -> str:
    """'auto' -> 'vmem' while the JAX package would keep K|V resident in
    VMEM, else 'dma'; an explicit 'vmem'/'dma' is honored."""
    if gather != "auto":
        return gather
    kv_bytes = n_rows * 2 * d * itemsize
    tile_overhead = 5 * tile_rows * d * 4 + 6 * 1024 * 1024
    return ("vmem" if kv_bytes <= _VMEM_KV_BUDGET
            and kv_bytes + tile_overhead <= _VMEM_TOTAL_BUDGET else "dma")


def _auto_group(sp: int) -> int:
    return max(1, 768 // sp)


def _v6_usable(n: int, n_tiles_nodes: int, sp: int, d: int, itemsize: int,
               tile_nodes: int, group: int, gather: str) -> bool:
    """The JAX predicate for its whole-layer kernel: vmem gather, a tile
    grid covering every node, and the VMEM accounting within budget."""
    return (gather == "vmem" and n_tiles_nodes >= n
            and _v6_fits(n_tiles_nodes * sp, d, itemsize,
                         tile_rows=tile_nodes * sp, group_rows=group * sp, sp=sp))


# ---------------------------------------------------------------- plain versions


def edge_attention_sums_plain(q_rows, kv_rows, tile_senders, tile_valid,
                              recv_ptr, recv_slots, *, s, sp, num_heads,
                              softmax, invdeg=None):
    """Per-receiver sums over the receiver-major index, in plain torch:
    gather q / k|v per live slot, attend over the S real key rows, scale by
    validity (times invdeg when given), index_add into receiver rows.
    Returns [NT*sp, D] f32 with pad token rows 0."""
    nt = recv_ptr.numel() - 1
    d = q_rows.shape[1]
    recv = torch.repeat_interleave(
        torch.arange(nt, device=q_rows.device),
        (recv_ptr[1:] - recv_ptr[:-1]).long())
    slots = recv_slots.long()
    snd = tile_senders.reshape(-1)[slots].long()
    w = tile_valid.reshape(-1)[slots].to(torch.float32)
    if invdeg is not None:
        w = w * invdeg[recv]
    q = q_rows.reshape(nt, sp, d)[:, :s][recv]
    kv = kv_rows.reshape(nt, sp, 2 * d)[:, :s][snd]
    msg, _ = attention_core(q, kv[..., :d], kv[..., d:], num_heads, softmax=softmax)
    acc = torch.zeros(nt, s, d, dtype=torch.float32, device=q_rows.device)
    acc.index_add_(0, recv, msg * w[:, None, None])
    return F.pad(acc, (0, 0, 0, sp - s)).reshape(nt * sp, d)


def qkv_projection_plain(x_rows, w_qkv, b_qkv):
    return x_rows @ w_qkv + b_qkv


def edge_attention_layer_plain(x_rows, w_qkv, b_qkv, w_out, b_out, invdeg,
                               tile_senders, tile_valid, recv_ptr, recv_slots,
                               *, s, sp, num_heads, softmax):
    """Whole layer in plain torch: project, mean over in-edges (1/degree
    folded into each edge), out-projection, b_out on live rows only."""
    d = x_rows.shape[1]
    nt = recv_ptr.numel() - 1
    qkv = qkv_projection_plain(x_rows, w_qkv, b_qkv)
    mean = edge_attention_sums_plain(
        qkv[:, :d], qkv[:, d:], tile_senders, tile_valid, recv_ptr, recv_slots,
        s=s, sp=sp, num_heads=num_heads, softmax=softmax, invdeg=invdeg)
    out = mean.reshape(nt, sp, d)[:, :s] @ w_out
    out = out + b_out * (invdeg > 0).to(out.dtype)[:, None, None]
    return F.pad(out, (0, 0, 0, sp - s)).reshape(nt * sp, d)


# ---------------------------------------------------------------- kernels

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ampnet_edge_attention_sums": [_P, _I, _P, _I, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _P],
    "ampnet_edge_attention_layer": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _P],
    "ampnet_qkv_projection": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    "ampnet_edge_attention_smem_bytes": [_I, _I, _I],
}


def _entry(lib_name: str, fn_name: str):
    lib = build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = _SIGNATURES[fn_name]
    fn.restype = ctypes.c_size_t if fn_name.endswith("_bytes") else ctypes.c_int
    return lib, fn


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_f32_rows(name, t, device, rows, cols):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got {t.dtype} on {t.device}")
    if t.dim() != 2 or tuple(t.shape) != (rows, cols) or t.stride(1) != 1:
        raise ValueError(f"{name}: expected [{rows}, {cols}] rows with unit column "
                         f"stride, got {tuple(t.shape)} strides {t.stride()}")


def _check_index(name, t, device, numel=None):
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous int32 on {device}, "
                         f"got {t.dtype} on {t.device}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: expected {numel} elements, got {t.numel()}")


def _check_layout(device, tile_senders, tile_valid, recv_ptr, recv_slots):
    _check_index("tile_senders", tile_senders, device)
    _check_index("tile_valid", tile_valid, device, tile_senders.numel())
    _check_index("recv_ptr", recv_ptr, device)
    _check_index("recv_slots", recv_slots, device)


def _check_smem(s, d, num_heads):
    lib, fn = _entry("edge_attention", "ampnet_edge_attention_smem_bytes")
    need = fn(s, d, num_heads)
    if need > _MAX_SMEM:
        raise ValueError(f"edge attention at S={s}, D={d}, H={num_heads} needs "
                         f"{need} B of shared memory per block (> {_MAX_SMEM})")


def edge_attention_sums(q_rows, kv_rows, tile_senders, tile_valid, recv_ptr,
                        recv_slots, *, s, sp, num_heads, softmax):
    """K1: per-receiver sums [NT*sp, D] f32 (pad token rows 0).

    q_rows [NT*sp, D] and kv_rows [NT*sp, 2D] may be row-strided views
    (e.g. column slices of one packed q|k|v buffer); the layout arrays are
    int32 (format.py). CPU tensors run the plain version."""
    if not q_rows.is_cuda:
        return edge_attention_sums_plain(
            q_rows, kv_rows, tile_senders, tile_valid, recv_ptr, recv_slots,
            s=s, sp=sp, num_heads=num_heads, softmax=softmax)
    dev = q_rows.device
    nt = recv_ptr.numel() - 1
    d = q_rows.shape[1]
    if d % num_heads:
        raise ValueError(f"D={d} is not a multiple of num_heads={num_heads}")
    _check_f32_rows("q_rows", q_rows, dev, nt * sp, d)
    _check_f32_rows("kv_rows", kv_rows, dev, nt * sp, 2 * d)
    _check_layout(dev, tile_senders, tile_valid, recv_ptr, recv_slots)
    _check_smem(s, d, num_heads)
    out = torch.empty(nt * sp, d, dtype=torch.float32, device=dev)
    lib, fn = _entry("edge_attention", "ampnet_edge_attention_sums")
    build.check(lib, fn(
        q_rows.data_ptr(), q_rows.stride(0), kv_rows.data_ptr(), kv_rows.stride(0),
        tile_senders.data_ptr(), tile_valid.data_ptr(), recv_ptr.data_ptr(),
        recv_slots.data_ptr(), out.data_ptr(), nt, s, sp, d, num_heads,
        int(softmax), _stream()), "edge_attention_sums")
    edge_attention_sums.launches += 1
    return out


edge_attention_sums.launches = 0


def edge_attention_layer(x_rows, w_qkv, b_qkv, w_out, b_out, invdeg,
                         tile_senders, tile_valid, recv_ptr, recv_slots, *,
                         s, sp, num_heads, softmax):
    """K2: the whole layer over raw token rows x_rows [NT*sp, D] -> output
    rows [NT*sp, D] f32 (pad token rows 0). invdeg [NT] is 1/degree of the
    runtime mask (0 for degree 0). Two launches: the q|k|v projection, then
    attention with the mean, out-projection and live-row bias fused."""
    if not x_rows.is_cuda:
        return edge_attention_layer_plain(
            x_rows, w_qkv, b_qkv, w_out, b_out, invdeg, tile_senders,
            tile_valid, recv_ptr, recv_slots, s=s, sp=sp,
            num_heads=num_heads, softmax=softmax)
    dev = x_rows.device
    nt = recv_ptr.numel() - 1
    d = x_rows.shape[1]
    if d % num_heads:
        raise ValueError(f"D={d} is not a multiple of num_heads={num_heads}")
    _check_f32_rows("x_rows", x_rows, dev, nt * sp, d)
    _check_f32_rows("w_qkv", w_qkv, dev, d, 3 * d)
    _check_f32_rows("w_out", w_out, dev, d, d)
    for name, t, numel in (("b_qkv", b_qkv, 3 * d), ("b_out", b_out, d), ("invdeg", invdeg, nt)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != numel:
            raise ValueError(f"{name}: expected {numel} contiguous float32 on {dev}")
    if not w_qkv.is_contiguous() or not w_out.is_contiguous():
        raise ValueError("w_qkv and w_out must be contiguous")
    _check_layout(dev, tile_senders, tile_valid, recv_ptr, recv_slots)
    _check_smem(s, d, num_heads)
    qkv = torch.empty(nt * sp, 3 * d, dtype=torch.float32, device=dev)
    out = torch.empty(nt * sp, d, dtype=torch.float32, device=dev)
    stream = _stream()
    lib, proj = _entry("qkv_projection", "ampnet_qkv_projection")
    build.check(lib, proj(x_rows.data_ptr(), x_rows.stride(0), w_qkv.data_ptr(),
                          b_qkv.data_ptr(), qkv.data_ptr(), 3 * d, nt * sp, 3 * d,
                          d, stream), "qkv_projection")
    lib, attn = _entry("edge_attention", "ampnet_edge_attention_layer")
    build.check(lib, attn(qkv.data_ptr(), 3 * d, tile_senders.data_ptr(),
                          tile_valid.data_ptr(), recv_ptr.data_ptr(),
                          recv_slots.data_ptr(), invdeg.data_ptr(),
                          w_out.data_ptr(), b_out.data_ptr(), out.data_ptr(),
                          nt, s, sp, d, num_heads, int(softmax), stream),
                "edge_attention_layer")
    edge_attention_layer.launches += 1
    return out


edge_attention_layer.launches = 0

KERNEL_WRAPPERS = (edge_attention_sums, edge_attention_layer)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


# ---------------------------------------------------------------- the op


def _forward(x, params, receivers, edge_mask, tile_senders, tile_valid,
             recv_ptr, recv_slots, num_heads, softmax, tile_nodes, gather):
    num_tiles = tile_senders.shape[0]
    n, s, d = x.shape
    if x.dtype != torch.float32:
        raise ValueError(f"the fused op computes in float32, got {x.dtype}")
    # tile_nodes must MATCH the value the layout was built with (recv_local
    # = receiver % tile_nodes); a mismatch reads wrong rows silently. The
    # tile grid must cover x's rows exactly.
    if not ((num_tiles - 1) * tile_nodes < n <= num_tiles * tile_nodes):
        raise ValueError(
            f"tile_nodes={tile_nodes} inconsistent with layout: {num_tiles} "
            f"tiles x {tile_nodes} vs {n} node rows — pass the tile_nodes "
            f"the layout was built with (compute_layout)")
    nt = num_tiles * tile_nodes
    if recv_ptr.numel() != nt + 1:
        raise ValueError(f"recv_ptr has {recv_ptr.numel()} entries, expected {nt + 1}")
    sp = -(-s // 8) * 8          # the JAX package's f32 token-row stride
    itemsize = 4
    gather = _resolve_gather(gather, max(n, nt) * sp, d, itemsize,
                             tile_rows=tile_nodes * sp)
    # pad tokens to the row stride BEFORE projecting, and node rows to the
    # tile grid; pad rows are never read as keys or kept as queries
    x_rows = F.pad(x, (0, 0, 0, sp - s, 0, nt - n)).reshape(nt * sp, d)
    count = segment_count(receivers, n, edge_mask)

    if _v6_usable(n, nt, sp, d, itemsize, tile_nodes, _auto_group(sp), gather):
        invdeg = torch.where(count > 0, 1.0 / count.clamp_min(1.0),
                             torch.zeros_like(count))
        rows = edge_attention_layer(
            x_rows, params.w_qkv.contiguous(), params.b_qkv.contiguous(),
            params.w_out.contiguous(), params.b_out.contiguous(),
            F.pad(invdeg, (0, nt - n)), tile_senders, tile_valid, recv_ptr,
            recv_slots, s=s, sp=sp, num_heads=num_heads, softmax=softmax)
        return rows[: n * sp].reshape(n, sp, d)[:, :s]

    qkv = x_rows @ params.w_qkv + params.b_qkv
    sums = edge_attention_sums(
        qkv[:, :d], qkv[:, d:], tile_senders, tile_valid, recv_ptr, recv_slots,
        s=s, sp=sp, num_heads=num_heads, softmax=softmax)
    sums = sums[: n * sp].reshape(n, sp, d)[:, :s]
    mean = sums / count.clamp_min(1.0)[:, None, None]
    out = mean @ params.w_out + params.b_out
    return torch.where((count > 0)[:, None, None], out, torch.zeros_like(out))


class _FusedForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, w_out, b_out, args):
        return _forward(x, MHAParams(w_qkv, b_qkv, w_out, b_out), *args)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "amp_edge_attention_fused is forward-only: its backward kernels "
            "are not ported yet — use the plain path (use_pallas=False) to "
            "train")


def amp_edge_attention_fused(
    x: torch.Tensor,                 # [N, S, D]
    params: MHAParams,
    receivers: torch.Tensor,         # [E] (degree counts)
    edge_mask: Optional[torch.Tensor],
    tile_senders: torch.Tensor,      # [T, EMAX] int32 (compute_layout)
    tile_valid: torch.Tensor,        # [T, EMAX] int32, may carry a RUNTIME mask
    recv_ptr: torch.Tensor,          # [T*TN + 1] int32 STRUCTURAL trip counts
    recv_slots: torch.Tensor,        # [live slots] int32
    num_heads: int,
    softmax: bool = True,
    tile_nodes: int = DEFAULT_TILE_NODES,
    gather: str = "auto",
) -> torch.Tensor:
    """AMPConv forward through the Hopper kernels; same result as
    ``ops.edge_attention.amp_edge_attention`` ([N, S, D]).

    ``gather`` ('auto' | 'vmem' | 'dma') only feeds the JAX package's
    dispatch rule, which picks K2 (its v6 whole-layer kernel) or K1 plus
    torch glue; K1 itself is the same kernel for both gathers."""
    return _FusedForward.apply(
        x, params.w_qkv, params.b_qkv, params.w_out, params.b_out,
        (receivers, edge_mask, tile_senders, tile_valid, recv_ptr, recv_slots,
         num_heads, softmax, tile_nodes, gather))
