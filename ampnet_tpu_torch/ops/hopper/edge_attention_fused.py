"""Fused AMPConv edge attention on Hopper: the JAX package's
``amp_edge_attention_pallas`` with its forward ``_pallas_core_dynamic`` and
its backward ``_pallas_bwd_dynamic``, scatter-free and stream branch
(``ampnet_tpu/ops/pallas/edge_attention_fused.py:1953-2098, 2430-2505,
2101-2296``).

Two hand-written forward kernels (``csrc/``), each beside its plain torch
version:

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

The op is a ``torch.autograd.Function``. When a gradient is needed its
forward is K1 plus glue whatever the dispatch says (the JAX rule: the
training forward keeps the sums and counts for the backward, which the
whole-layer kernel never materializes). Its backward is kernels between
torch glue (the out-projection gradients and dsum before them, the
in-projection gradients ``_finish_bwd`` after): with the sender side of
the layout and ``scatterfree`` the two kernels of
``edge_attention_bwd_scatterfree.py`` (K3 pass R, K4 pass S); without a
sender side, or with ``scatterfree=False``, the stream backward of
``edge_attention_bwd.py`` (K5 pass A, then pass B in torch).
``fused_bwd=False`` takes the gradients by autograd through the plain op.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. Each wrapper counts its launches in
``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch
import torch.nn.functional as F

from ampnet_tpu_torch.ops.edge_attention import (
    MHAParams,
    amp_edge_attention,
    attention_core,
)
from ampnet_tpu_torch.ops.hopper import build
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as bwd_stream
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
from ampnet_tpu_torch.ops.hopper.format import DEFAULT_TILE_NODES
from ampnet_tpu_torch.ops.hopper.launch import (
    I,
    P,
    check_f32_rows,
    check_smem,
    check_walk,
    entry,
    stream,
)
from ampnet_tpu_torch.ops.segment import segment_count

# Which fused backward a layout WITH a sender side gets when the caller does
# not say (the JAX package's environment variable and default): scatter-free
# unless AMPNET_SCATTERFREE_BWD is set to something other than 1.
SCATTERFREE_BWD_DEFAULT = os.environ.get("AMPNET_SCATTERFREE_BWD", "1") == "1"

# The JAX package's dispatch constants (its env-var defaults), mirrored so
# the choice between K1 and K2 is the one the JAX package makes.
_VMEM_KV_BUDGET = 80 * 1024 * 1024
_VMEM_TOTAL_BUDGET = 96 * 1024 * 1024
_V6_VMEM_LIMIT = 120 * 1024 * 1024


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

_SIGNATURES = {
    "ampnet_edge_attention_sums": [P, I, P, I, P, P, P, P, P,
                                   I, I, I, I, I, I, P],
    "ampnet_edge_attention_layer": [P, I, P, P, P, P, P, P, P, P,
                                    I, I, I, I, I, I, P],
    "ampnet_qkv_projection": [P, I, P, P, P, I, I, I, I, P],
}


def _entry(lib_name: str, fn_name: str):
    return entry(lib_name, fn_name, _SIGNATURES[fn_name])


def _check_layout(device, tile_senders, tile_valid, recv_ptr, recv_slots):
    check_walk(device, tile_senders, tile_valid, recv_ptr, recv_slots,
               ("tile_senders", "tile_valid", "recv_ptr", "recv_slots"))


def _check_smem(s, d, num_heads):
    _, fn = entry("edge_attention", "ampnet_edge_attention_smem_bytes",
                  [I, I, I], ctypes.c_size_t)
    check_smem(fn(s, d, num_heads),
               f"edge attention at S={s}, D={d}, H={num_heads}")


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
    check_f32_rows("q_rows", q_rows, dev, nt * sp, d)
    check_f32_rows("kv_rows", kv_rows, dev, nt * sp, 2 * d)
    _check_layout(dev, tile_senders, tile_valid, recv_ptr, recv_slots)
    _check_smem(s, d, num_heads)
    out = torch.empty(nt * sp, d, dtype=torch.float32, device=dev)
    lib, fn = _entry("edge_attention", "ampnet_edge_attention_sums")
    build.check(lib, fn(
        q_rows.data_ptr(), q_rows.stride(0), kv_rows.data_ptr(), kv_rows.stride(0),
        tile_senders.data_ptr(), tile_valid.data_ptr(), recv_ptr.data_ptr(),
        recv_slots.data_ptr(), out.data_ptr(), nt, s, sp, d, num_heads,
        int(softmax), stream()), "edge_attention_sums")
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
    check_f32_rows("x_rows", x_rows, dev, nt * sp, d)
    check_f32_rows("w_qkv", w_qkv, dev, d, 3 * d)
    check_f32_rows("w_out", w_out, dev, d, d)
    for name, t, numel in (("b_qkv", b_qkv, 3 * d), ("b_out", b_out, d), ("invdeg", invdeg, nt)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != numel:
            raise ValueError(f"{name}: expected {numel} contiguous float32 on {dev}")
    if not w_qkv.is_contiguous() or not w_out.is_contiguous():
        raise ValueError("w_qkv and w_out must be contiguous")
    _check_layout(dev, tile_senders, tile_valid, recv_ptr, recv_slots)
    _check_smem(s, d, num_heads)
    qkv = torch.empty(nt * sp, 3 * d, dtype=torch.float32, device=dev)
    out = torch.empty(nt * sp, d, dtype=torch.float32, device=dev)
    cuda_stream = stream()
    lib, proj = _entry("qkv_projection", "ampnet_qkv_projection")
    build.check(lib, proj(x_rows.data_ptr(), x_rows.stride(0), w_qkv.data_ptr(),
                          b_qkv.data_ptr(), qkv.data_ptr(), 3 * d, nt * sp, 3 * d,
                          d, cuda_stream), "qkv_projection")
    lib, attn = _entry("edge_attention", "ampnet_edge_attention_layer")
    build.check(lib, attn(qkv.data_ptr(), 3 * d, tile_senders.data_ptr(),
                          tile_valid.data_ptr(), recv_ptr.data_ptr(),
                          recv_slots.data_ptr(), invdeg.data_ptr(),
                          w_out.data_ptr(), b_out.data_ptr(), out.data_ptr(),
                          nt, s, sp, d, num_heads, int(softmax), cuda_stream),
                "edge_attention_layer")
    edge_attention_layer.launches += 1
    return out


edge_attention_layer.launches = 0

KERNEL_WRAPPERS = (edge_attention_sums, edge_attention_layer,
                   bwd.edge_attention_bwd_dq, bwd.edge_attention_bwd_dkv,
                   bwd_stream.edge_attention_bwd_stream)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


# ---------------------------------------------------------------- the op


def _grid(x, tile_senders, recv_ptr, tile_nodes, gather):
    """Checks x against the layout; returns (nt, sp, gather) with the row
    stride and the gather resolved ONCE, so forward and backward agree."""
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
    gather = _resolve_gather(gather, max(n, nt) * sp, d, 4,
                             tile_rows=tile_nodes * sp)
    return nt, sp, gather


def _token_rows(x, nt, sp):
    """[N, S, D] -> [NT*sp, D]: tokens padded to the row stride and node
    rows to the tile grid; pad rows are never read as keys or kept as
    queries."""
    n, s, d = x.shape
    return F.pad(x, (0, 0, 0, sp - s, 0, nt - n)).reshape(nt * sp, d)


def _finish_bwd(x, w_qkv, dq_nodes, dkv_nodes):
    """In-projection gradients without the [N, S, 3D] concat: dq and dkv go
    through separate products against the split w_qkv columns."""
    d = dq_nodes.shape[-1]
    dx = dq_nodes @ w_qkv[:, :d].T + dkv_nodes @ w_qkv[:, d:].T
    d_wqkv = torch.cat([torch.einsum("nsd,nse->de", x, dq_nodes),
                        torch.einsum("nsd,nse->de", x, dkv_nodes)], dim=1)
    d_bqkv = torch.cat([dq_nodes.sum(dim=(0, 1)), dkv_nodes.sum(dim=(0, 1))])
    return dx, d_wqkv, d_bqkv


class _FusedOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, w_out, b_out, args):
        (senders, receivers, edge_mask, tile_senders, tile_valid, recv_ptr,
         recv_slots, snd, num_heads, softmax, tile_nodes, gather, backward) = args
        # snd: None, or the sender-tiled side pass S walks (snd_receivers,
        # snd_valid, snd_ptr, snd_slots). backward: None (no gradient will be
        # asked), 'scatterfree' (K3 + K4), 'stream' (K5 + pass B) or 'plain'
        # (autograd through the plain op).
        n, s, d = x.shape
        nt, sp, gather = _grid(x, tile_senders, recv_ptr, tile_nodes, gather)
        x_rows = _token_rows(x, nt, sp)
        count = segment_count(receivers, n, edge_mask)

        # the whole-layer kernel never materializes the sums the backward
        # needs, so it is the no-grad route only (the JAX rule)
        if backward is None and _v6_usable(n, nt, sp, d, 4, tile_nodes,
                                           _auto_group(sp), gather):
            invdeg = torch.where(count > 0, 1.0 / count.clamp_min(1.0),
                                 torch.zeros_like(count))
            rows = edge_attention_layer(
                x_rows, w_qkv.contiguous(), b_qkv.contiguous(),
                w_out.contiguous(), b_out.contiguous(),
                F.pad(invdeg, (0, nt - n)), tile_senders, tile_valid, recv_ptr,
                recv_slots, s=s, sp=sp, num_heads=num_heads, softmax=softmax)
            return rows[: n * sp].reshape(n, sp, d)[:, :s]

        qkv = x_rows @ w_qkv + b_qkv
        sums = edge_attention_sums(
            qkv[:, :d], qkv[:, d:], tile_senders, tile_valid, recv_ptr, recv_slots,
            s=s, sp=sp, num_heads=num_heads, softmax=softmax)
        sums = sums[: n * sp].reshape(n, sp, d)[:, :s]
        mean = sums / count.clamp_min(1.0)[:, None, None]
        out = mean @ w_out + b_out
        out = torch.where((count > 0)[:, None, None], out, torch.zeros_like(out))
        ctx.backward_route = backward
        if backward == "plain":
            ctx.save_for_backward(x, w_qkv, b_qkv, w_out, b_out, senders, receivers,
                                  edge_mask)
            ctx.kernel_args = dict(num_heads=num_heads, softmax=softmax)
        elif backward is not None:
            ctx.save_for_backward(x, w_qkv, b_qkv, w_out, sums, count, tile_senders,
                                  tile_valid, recv_ptr, recv_slots, *(snd or ()))
            ctx.kernel_args = dict(s=s, sp=sp, num_heads=num_heads, softmax=softmax)
            # the JAX rule: only the dma gather folds its stream in chunks
            ctx.chunked = gather != "vmem"
        return out

    @staticmethod
    def backward(ctx, gout):
        if ctx.backward_route == "plain":
            return (*_plain_bwd(ctx.saved_tensors, gout, **ctx.kernel_args), None)
        (x, w_qkv, b_qkv, w_out, sums, count, tile_senders, tile_valid, recv_ptr,
         recv_slots, *snd) = ctx.saved_tensors
        kw = ctx.kernel_args
        n, s, d = x.shape
        nt, sp = recv_ptr.numel() - 1, kw["sp"]
        qkv = _token_rows(x, nt, sp) @ w_qkv + b_qkv

        # out-projection and mean, in torch as the JAX package leaves them to XLA
        gm = torch.where((count > 0)[:, None, None], gout, torch.zeros_like(gout))
        denom = count.clamp_min(1.0)[:, None, None]
        d_wout = torch.einsum("nsd,nse->de", sums / denom, gm)
        d_bout = gm.sum(dim=(0, 1))
        # dsum = gradient of the per-receiver SUM of messages, 0 on pad token
        # rows and pad node rows
        dsum_rows = _token_rows((gm @ w_out.T) / denom, nt, sp)

        if ctx.backward_route == "scatterfree":
            qdm = torch.cat([qkv[:, :d], dsum_rows], dim=1)     # packed [Q | dsum]
            dq_rows = bwd.edge_attention_bwd_dq(
                qkv[:, :d], qkv[:, d:], dsum_rows, tile_senders, tile_valid,
                recv_ptr, recv_slots, **kw)
            dkv_rows = bwd.edge_attention_bwd_dkv(qdm, qkv[:, d:], *snd, **kw)
            dkv_nodes = dkv_rows.reshape(nt, sp, 2 * d)[:n, :s]
        else:
            dq_rows, dkv_nodes = bwd_stream.stream_backward(
                qkv[:, :d], qkv[:, d:], dsum_rows, tile_senders, tile_valid,
                recv_ptr, recv_slots, **kw,
                chunk_bytes=bwd_stream._STREAM_CHUNK_BYTES if ctx.chunked else None)
            dkv_nodes = dkv_nodes[:n]
        dq_nodes = dq_rows.reshape(nt, sp, d)[:n, :s]
        dx, d_wqkv, d_bqkv = _finish_bwd(x, w_qkv, dq_nodes, dkv_nodes)
        return dx, d_wqkv, d_bqkv, d_wout, d_bout, None


def _plain_bwd(saved, gout, *, num_heads, softmax):
    """fused_bwd=False: the five gradients by autograd through the plain op
    (the JAX package's ``bwd_xla``), the forward recomputed."""
    x, w_qkv, b_qkv, w_out, b_out, senders, receivers, edge_mask = saved
    leaves = [t.detach().requires_grad_() for t in (x, w_qkv, b_qkv, w_out, b_out)]
    with torch.enable_grad():
        out, _ = amp_edge_attention(
            leaves[0], senders, receivers, edge_mask, MHAParams(*leaves[1:]),
            num_heads, softmax=softmax, return_weights=False)
    return torch.autograd.grad(out, leaves, gout)


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
    snd_receivers: Optional[torch.Tensor] = None,  # [T, EMAXS] the sender-tiled
    snd_valid: Optional[torch.Tensor] = None,      # side (snd_valid may carry
    snd_ptr: Optional[torch.Tensor] = None,        # the RUNTIME mask): needed
    snd_slots: Optional[torch.Tensor] = None,      # by passes R and S
    scatterfree: Optional[bool] = None,  # None = AMPNET_SCATTERFREE_BWD
    fused_bwd: bool = True,
    senders: Optional[torch.Tensor] = None,        # [E], for fused_bwd=False
) -> torch.Tensor:
    """AMPConv through the Hopper kernels; same result and gradients as
    ``ops.edge_attention.amp_edge_attention`` ([N, S, D]).

    ``gather`` ('auto' | 'vmem' | 'dma') only feeds the JAX package's
    dispatch rule, which picks K2 (its v6 whole-layer kernel) or K1 plus
    torch glue for a forward that needs no gradient; each kernel is the same
    for both gathers. When autograd will ask for a gradient the forward is
    K1 plus glue. The backward is the scatter-free one (K3, K4) when the
    four ``snd_*`` arrays are given and ``scatterfree`` holds, else the
    stream backward (K5, then pass B in torch, folded in tile chunks under
    the 'dma' gather); ``fused_bwd=False`` recomputes through the plain op
    under autograd instead and needs ``senders``."""
    snd = (snd_receivers, snd_valid, snd_ptr, snd_slots)
    if any(t is None for t in snd):
        if any(t is not None for t in snd):
            raise ValueError("pass all of snd_receivers, snd_valid, snd_ptr and "
                             "snd_slots, or none of them")
        snd = None
    elif snd_receivers.shape[0] != tile_senders.shape[0]:
        raise ValueError(
            f"sender layout has {snd_receivers.shape[0]} tiles vs receiver "
            f"layout's {tile_senders.shape[0]} — both must be built with the "
            f"same tile_nodes over the same padded node count")
    if scatterfree is None:
        scatterfree = SCATTERFREE_BWD_DEFAULT
    if not scatterfree:
        snd = None
    if not fused_bwd and senders is None:
        raise ValueError("fused_bwd=False differentiates the plain op and needs "
                         "the edge list's senders")
    # whether autograd will record this call (Function.forward cannot tell:
    # it runs with grad mode off and sees needs_input_grad under no_grad too),
    # and which backward it then gets
    backward = None
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        backward = ("plain" if not fused_bwd
                    else "scatterfree" if snd is not None else "stream")
    return _FusedOp.apply(
        x, params.w_qkv, params.b_qkv, params.w_out, params.b_out,
        (senders, receivers, edge_mask, tile_senders, tile_valid, recv_ptr,
         recv_slots, snd, num_heads, softmax, tile_nodes, gather, backward))
