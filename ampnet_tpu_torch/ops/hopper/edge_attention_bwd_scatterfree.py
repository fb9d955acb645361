"""Scatter-free backward of the fused edge attention on Hopper: passes R
and S of the JAX package's ``fused_edge_bwd_dq`` / ``fused_edge_bwd_dkv``
(``ampnet_tpu/ops/pallas/edge_attention_bwd_scatterfree.py``).

Two hand-written kernels (``csrc/edge_attention_bwd.cu``), each beside its
plain torch version:

* ``edge_attention_bwd_dq`` (K3) — pass R: per edge, recompute the scores
  and the softmax, dW = dMsg V^T, the softmax backward, dQ = dS K / sqrt(dh);
  summed per receiver over the receiver-major index. Counterpart of both
  ``_dq_kernel_vmem`` and ``_dq_kernel_dma``.
* ``edge_attention_bwd_dkv`` (K4) — pass S: the same recompute over the
  sender-tiled side, dV = W^T dMsg and dK = dS^T Q / sqrt(dh), summed per
  sender over the sender-major index (``format.py``: ``snd_ptr``,
  ``snd_slots``). Counterpart of ``_dkv_kernel_vmem`` and ``_dkv_kernel_dma``.

One kernel per pass serves both gathers: Hopper reads the gathered rows
from device memory either way. Neither uses atomics, so the sums are taken
in slot order and repeat bit for bit.

The plain versions spell the same arithmetic out in tensor math over the
same index (gather, recompute, softmax backward, ``index_add_``); they are
not autograd of the forward. A wrapper given CPU tensors runs its plain
version; given CUDA tensors it launches its kernel or raises. Each wrapper
counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ampnet_tpu_torch.ops.hopper.launch import (
    I,
    P,
    check_f32_rows,
    check_smem,
    check_walk,
    entry,
    stream,
)
from ampnet_tpu_torch.ops.hopper import build

_LIB = "edge_attention_bwd"
_SIGNATURES = {
    "ampnet_edge_attention_bwd_dq": [P, I, P, I, P, I, P, P, P, P, P,
                                     I, I, I, I, I, I, P],
    "ampnet_edge_attention_bwd_dkv": [P, I, P, I, P, P, P, P, P,
                                      I, I, I, I, I, I, P],
}


# ---------------------------------------------------------------- plain versions


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[E, S, D] -> [E, H, S, Dh]."""
    e, s, d = t.shape
    return t.reshape(e, s, num_heads, d // num_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """[E, H, S, Dh] -> [E, S, D]."""
    e, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(e, s, h * dh)


def _recompute(q, k, v, dm, num_heads, softmax):
    """Per edge and head: the scaled queries, keys, dMsg, the weights W
    [E, H, Sq, Sk] and dS, the gradient of the scaled scores."""
    scale = 1.0 / (q.shape[-1] // num_heads) ** 0.5
    qh = _heads(q, num_heads) * scale
    kh, vh, dmh = (_heads(t, num_heads) for t in (k, v, dm))
    scores = qh @ kh.transpose(-1, -2)
    dw = dmh @ vh.transpose(-1, -2)
    if softmax:
        w = torch.softmax(scores, dim=-1)
        ds = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    else:
        w, ds = scores, dw
    return qh, kh, dmh, w, ds, scale


def _walk(peer_ids, valid, ptr, slots):
    """Per walked slot: its node (block), its peer and its validity."""
    nodes = ptr.numel() - 1
    own = torch.repeat_interleave(torch.arange(nodes, device=ptr.device),
                                  (ptr[1:] - ptr[:-1]).long())
    slots = slots.long()
    return own, peer_ids.reshape(-1)[slots].long(), \
        valid.reshape(-1)[slots].to(torch.float32)


def edge_attention_bwd_dq_plain(q_rows, kv_rows, dsum_rows, tile_senders,
                                tile_valid, recv_ptr, recv_slots, *, s, sp,
                                num_heads, softmax):
    """Pass R in plain torch: dQ rows [NT*sp, D] f32 (pad token rows 0)."""
    nt = recv_ptr.numel() - 1
    d = q_rows.shape[1]
    recv, snd, w = _walk(tile_senders, tile_valid, recv_ptr, recv_slots)
    q = q_rows.reshape(nt, sp, d)[:, :s][recv]
    dm = dsum_rows.reshape(nt, sp, d)[:, :s][recv]
    kv = kv_rows.reshape(nt, sp, 2 * d)[:, :s][snd]
    _, kh, _, _, ds, scale = _recompute(q, kv[..., :d], kv[..., d:], dm,
                                        num_heads, softmax)
    dq = _merge(ds @ kh) * scale
    acc = torch.zeros(nt, s, d, dtype=torch.float32, device=q_rows.device)
    acc.index_add_(0, recv, dq * w[:, None, None])
    return F.pad(acc, (0, 0, 0, sp - s)).reshape(nt * sp, d)


def edge_attention_bwd_dkv_plain(qdm_rows, kv_rows, snd_receivers, snd_valid,
                                 snd_ptr, snd_slots, *, s, sp, num_heads,
                                 softmax):
    """Pass S in plain torch: dK|dV rows [NT*sp, 2D] f32 (pad token rows 0)."""
    nt = snd_ptr.numel() - 1
    d = kv_rows.shape[1] // 2
    snd, recv, w = _walk(snd_receivers, snd_valid, snd_ptr, snd_slots)
    qdm = qdm_rows.reshape(nt, sp, 2 * d)[:, :s][recv]
    kv = kv_rows.reshape(nt, sp, 2 * d)[:, :s][snd]
    qh, _, dmh, wts, ds, _ = _recompute(qdm[..., :d], kv[..., :d], kv[..., d:],
                                        qdm[..., d:], num_heads, softmax)
    dk = _merge(ds.transpose(-1, -2) @ qh)      # qh carries the 1/sqrt(dh)
    dv = _merge(wts.transpose(-1, -2) @ dmh)
    acc = torch.zeros(nt, s, 2 * d, dtype=torch.float32, device=kv_rows.device)
    acc.index_add_(0, snd, torch.cat([dk, dv], dim=-1) * w[:, None, None])
    return F.pad(acc, (0, 0, 0, sp - s)).reshape(nt * sp, 2 * d)


# ---------------------------------------------------------------- kernels


def _check_shape(kernel: str, s: int, d: int, num_heads: int, dkv: bool) -> None:
    if d % num_heads:
        raise ValueError(f"D={d} is not a multiple of num_heads={num_heads}")
    _, fn = entry(_LIB, "ampnet_edge_attention_bwd_smem_bytes", [I, I, I, I],
                  ctypes.c_size_t)
    check_smem(fn(s, d, num_heads, int(dkv)),
               f"{kernel} at S={s}, D={d}, H={num_heads}")


def edge_attention_bwd_dq(q_rows, kv_rows, dsum_rows, tile_senders, tile_valid,
                          recv_ptr, recv_slots, *, s, sp, num_heads, softmax):
    """K3, pass R: dQ rows [NT*sp, D] f32 (pad token rows 0).

    q_rows, dsum_rows [NT*sp, D] and kv_rows [NT*sp, 2D] may be row-strided
    views; dsum is the gradient of the per-receiver SUM of messages. The
    index arrays are int32 (format.py). CPU tensors run the plain version."""
    if not q_rows.is_cuda:
        return edge_attention_bwd_dq_plain(
            q_rows, kv_rows, dsum_rows, tile_senders, tile_valid, recv_ptr,
            recv_slots, s=s, sp=sp, num_heads=num_heads, softmax=softmax)
    dev = q_rows.device
    nt = recv_ptr.numel() - 1
    d = q_rows.shape[1]
    check_f32_rows("q_rows", q_rows, dev, nt * sp, d)
    check_f32_rows("dsum_rows", dsum_rows, dev, nt * sp, d)
    check_f32_rows("kv_rows", kv_rows, dev, nt * sp, 2 * d)
    check_walk(dev, tile_senders, tile_valid, recv_ptr, recv_slots,
               ("tile_senders", "tile_valid", "recv_ptr", "recv_slots"))
    _check_shape("edge_attention_bwd_dq", s, d, num_heads, dkv=False)
    out = torch.empty(nt * sp, d, dtype=torch.float32, device=dev)
    name = "ampnet_edge_attention_bwd_dq"
    lib, fn = entry(_LIB, name, _SIGNATURES[name])
    build.check(lib, fn(
        q_rows.data_ptr(), q_rows.stride(0), dsum_rows.data_ptr(),
        dsum_rows.stride(0), kv_rows.data_ptr(), kv_rows.stride(0),
        tile_senders.data_ptr(), tile_valid.data_ptr(), recv_ptr.data_ptr(),
        recv_slots.data_ptr(), out.data_ptr(), nt, s, sp, d, num_heads,
        int(softmax), stream()), "edge_attention_bwd_dq")
    edge_attention_bwd_dq.launches += 1
    return out


edge_attention_bwd_dq.launches = 0


def edge_attention_bwd_dkv(qdm_rows, kv_rows, snd_receivers, snd_valid, snd_ptr,
                           snd_slots, *, s, sp, num_heads, softmax):
    """K4, pass S: dK|dV rows [NT*sp, 2D] f32 (pad token rows 0).

    qdm_rows [NT*sp, 2D] packs [Q | dsum] per row; kv_rows [NT*sp, 2D]; both
    may be row-strided views. snd_receivers holds GLOBAL receiver ids over
    the sender-tiled slots, snd_valid may carry a runtime mask, snd_ptr /
    snd_slots are the sender-major index. CPU tensors run the plain version."""
    if not kv_rows.is_cuda:
        return edge_attention_bwd_dkv_plain(
            qdm_rows, kv_rows, snd_receivers, snd_valid, snd_ptr, snd_slots,
            s=s, sp=sp, num_heads=num_heads, softmax=softmax)
    dev = kv_rows.device
    nt = snd_ptr.numel() - 1
    d = kv_rows.shape[1] // 2
    check_f32_rows("qdm_rows", qdm_rows, dev, nt * sp, 2 * d)
    check_f32_rows("kv_rows", kv_rows, dev, nt * sp, 2 * d)
    check_walk(dev, snd_receivers, snd_valid, snd_ptr, snd_slots,
               ("snd_receivers", "snd_valid", "snd_ptr", "snd_slots"))
    _check_shape("edge_attention_bwd_dkv", s, d, num_heads, dkv=True)
    out = torch.empty(nt * sp, 2 * d, dtype=torch.float32, device=dev)
    name = "ampnet_edge_attention_bwd_dkv"
    lib, fn = entry(_LIB, name, _SIGNATURES[name])
    build.check(lib, fn(
        qdm_rows.data_ptr(), qdm_rows.stride(0), kv_rows.data_ptr(),
        kv_rows.stride(0), snd_receivers.data_ptr(), snd_valid.data_ptr(),
        snd_ptr.data_ptr(), snd_slots.data_ptr(), out.data_ptr(), nt, s, sp, d,
        num_heads, int(softmax), stream()), "edge_attention_bwd_dkv")
    edge_attention_bwd_dkv.launches += 1
    return out


edge_attention_bwd_dkv.launches = 0
