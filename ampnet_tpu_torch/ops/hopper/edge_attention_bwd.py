"""Stream backward of the fused edge attention on Hopper: pass A and pass B
of the JAX package's ``ops/pallas/edge_attention_bwd.py``, for layouts that
have no sender side to walk (``compute_layout(sender_layout=False)``) and
for ``scatterfree=False``.

One hand-written kernel (``csrc/edge_attention_bwd.cu``, the third
instantiation of the body K3 and K4 share), beside its plain torch version:

* ``edge_attention_bwd_stream`` (K5) — pass A: per edge, recompute the
  scores and the softmax, dW = dMsg V^T, the softmax backward; dQ = dS K /
  sqrt(dh) summed per receiver over the receiver-major index (as K3), and
  the edge's own rows dK = dS^T Q / sqrt(dh) | dV = W^T dMsg written to a
  stream in device memory. Counterpart of all four bodies
  ``_bwd_kernel_vmem_v2``, ``_bwd_kernel_dma_compact``, ``_bwd_kernel_dma``
  and ``_bwd_kernel_vmem``: they compute one function and differ in how a
  TPU tile groups its edges and reaches K|V.

The stream is indexed by the layout's slot: slot (tile, j) owns rows
``(tile*EMAX + j)*SP .. +SP`` (the JAX strides follow its edge groups and
are not carried over). Slots that are never walked are never written; a
slot masked at run time is walked and holds zeros; rows S..SP-1 of a walked
slot are 0.

Pass B (``stream_to_senders``) is plain torch, as it is XLA in the JAX
package: gather the WALKED slots' rows and ``index_add_`` them by sender.
On the card ``index_add_`` sums with atomics, so dK|dV may differ in the
last bits from run to run (K4, the scatter-free pass S, repeats bit for
bit). ``stream_backward`` runs both passes over chunks of tiles so that the
live stream stays under a byte budget (``AMPNET_STREAM_CHUNK_BYTES``,
default 1 GiB, the JAX package's rule).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. The wrapper counts its launches in
``edge_attention_bwd_stream.launches``.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ampnet_tpu_torch.ops.hopper import build
from ampnet_tpu_torch.ops.hopper.edge_attention_bwd_scatterfree import (
    _merge,
    _recompute,
    _walk,
)
from ampnet_tpu_torch.ops.hopper.launch import (
    I,
    P,
    check_f32_rows,
    check_smem,
    check_walk,
    entry,
    stream,
)

_LIB = "edge_attention_bwd"
_SIGNATURE = [P, I, P, I, P, I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P]

# Cap on the LIVE part of the per-edge dK|dV stream (the JAX package's
# constant and environment variable): tiles run in chunks sized to it.
_STREAM_CHUNK_BYTES = int(
    os.environ.get("AMPNET_STREAM_CHUNK_BYTES", 1024 * 1024 * 1024))


def _tile_range(tile_senders, recv_ptr, tiles) -> Tuple[int, int, int, int]:
    """(t0, t1, tile_nodes, emax) of a launch over tiles [t0, t1)."""
    t, emax = tile_senders.shape
    nt = recv_ptr.numel() - 1
    if nt % t:
        raise ValueError(f"recv_ptr covers {nt} receivers, not a multiple of "
                         f"the layout's {t} tiles")
    t0, t1 = (0, t) if tiles is None else tiles
    if not 0 <= t0 < t1 <= t:
        raise ValueError(f"tiles={tiles} outside the layout's {t} tiles")
    return t0, t1, nt // t, emax


def _walk_bounds(recv_ptr, recv_slots, nodes) -> list:
    """recv_ptr at the given receivers, as Python ints: the slots a launch
    over receivers [nodes[i], nodes[i+1]) walks are recv_slots[b[i]:b[i+1]].
    The whole graph's bounds need no read of recv_ptr (a host sync on the
    card); any other set is read in one transfer."""
    if list(nodes) == [0, recv_ptr.numel() - 1]:
        return [0, recv_slots.numel()]
    return recv_ptr[list(nodes)].tolist()


# ---------------------------------------------------------------- plain version


def edge_attention_bwd_stream_plain(q_rows, kv_rows, dsum_rows, tile_senders,
                                    tile_valid, recv_ptr, recv_slots, *, s, sp,
                                    num_heads, softmax, tiles=None):
    """Pass A in plain torch over tiles [t0, t1) (default: all): (dQ rows
    [(t1-t0)*TN*sp, D], stream [(t1-t0)*EMAX*sp, 2D]), f32, pad token rows
    0; stream rows of slots that are not walked are 0 here (unwritten on
    the card)."""
    t0, t1, tn, emax = _tile_range(tile_senders, recv_ptr, tiles)
    nt = recv_ptr.numel() - 1
    d = q_rows.shape[1]
    n0, n1 = t0 * tn, t1 * tn
    a, b = _walk_bounds(recv_ptr, recv_slots, (n0, n1))
    slots = recv_slots[a:b]
    ptr = recv_ptr[n0: n1 + 1]
    recv, snd, w = _walk(tile_senders, tile_valid, ptr - ptr[0], slots)
    q = q_rows.reshape(nt, sp, d)[n0:n1, :s][recv]
    dm = dsum_rows.reshape(nt, sp, d)[n0:n1, :s][recv] * w[:, None, None]
    kv = kv_rows.reshape(nt, sp, 2 * d)[:, :s][snd]
    qh, kh, dmh, wts, ds, scale = _recompute(q, kv[..., :d], kv[..., d:], dm,
                                             num_heads, softmax)
    acc = torch.zeros(n1 - n0, s, d, dtype=torch.float32, device=q_rows.device)
    acc.index_add_(0, recv, _merge(ds @ kh) * scale)
    dk = _merge(ds.transpose(-1, -2) @ qh)      # qh carries the 1/sqrt(dh)
    dv = _merge(wts.transpose(-1, -2) @ dmh)
    out = torch.zeros((t1 - t0) * emax, sp, 2 * d, dtype=torch.float32,
                      device=q_rows.device)
    out[slots.long() - t0 * emax, :s] = torch.cat([dk, dv], dim=-1)
    return (F.pad(acc, (0, 0, 0, sp - s)).reshape((n1 - n0) * sp, d),
            out.reshape((t1 - t0) * emax * sp, 2 * d))


# ---------------------------------------------------------------- kernel


def edge_attention_bwd_stream(q_rows, kv_rows, dsum_rows, tile_senders, tile_valid,
                              recv_ptr, recv_slots, *, s, sp, num_heads, softmax,
                              tiles: Optional[Tuple[int, int]] = None):
    """K5, pass A over the receivers of tiles [t0, t1) (default: all):
    (dQ rows [(t1-t0)*TN*sp, D], dK|dV stream [(t1-t0)*EMAX*sp, 2D]), f32.

    q_rows, dsum_rows [NT*sp, D] and kv_rows [NT*sp, 2D] are the WHOLE
    graph's rows and may be row-strided views; dsum is the gradient of the
    per-receiver SUM of messages. The index arrays are int32 (format.py);
    tile_valid may carry a runtime mask. The stream holds sp rows per slot
    of the range, the first being slot t0*EMAX; rows of slots that are not
    walked are not written. CPU tensors run the plain version."""
    if not q_rows.is_cuda:
        return edge_attention_bwd_stream_plain(
            q_rows, kv_rows, dsum_rows, tile_senders, tile_valid, recv_ptr,
            recv_slots, s=s, sp=sp, num_heads=num_heads, softmax=softmax,
            tiles=tiles)
    dev = q_rows.device
    nt = recv_ptr.numel() - 1
    d = q_rows.shape[1]
    if d % num_heads:
        raise ValueError(f"D={d} is not a multiple of num_heads={num_heads}")
    check_f32_rows("q_rows", q_rows, dev, nt * sp, d)
    check_f32_rows("dsum_rows", dsum_rows, dev, nt * sp, d)
    check_f32_rows("kv_rows", kv_rows, dev, nt * sp, 2 * d)
    check_walk(dev, tile_senders, tile_valid, recv_ptr, recv_slots,
               ("tile_senders", "tile_valid", "recv_ptr", "recv_slots"))
    t0, t1, tn, emax = _tile_range(tile_senders, recv_ptr, tiles)
    _, smem = entry(_LIB, "ampnet_edge_attention_bwd_smem_bytes", [I, I, I, I],
                    ctypes.c_size_t)
    check_smem(smem(s, d, num_heads, 2),
               f"edge_attention_bwd_stream at S={s}, D={d}, H={num_heads}")
    nodes = (t1 - t0) * tn
    dq = torch.empty(nodes * sp, d, dtype=torch.float32, device=dev)
    out = torch.empty((t1 - t0) * emax * sp, 2 * d, dtype=torch.float32, device=dev)
    lib, fn = entry(_LIB, "ampnet_edge_attention_bwd_stream", _SIGNATURE)
    build.check(lib, fn(
        q_rows.data_ptr(), q_rows.stride(0), dsum_rows.data_ptr(),
        dsum_rows.stride(0), kv_rows.data_ptr(), kv_rows.stride(0),
        tile_senders.data_ptr(), tile_valid.data_ptr(), recv_ptr.data_ptr(),
        recv_slots.data_ptr(), dq.data_ptr(), out.data_ptr(), t0 * tn, nodes,
        t0 * emax, s, sp, d, num_heads, int(softmax), stream()),
        "edge_attention_bwd_stream")
    edge_attention_bwd_stream.launches += 1
    return dq, out


edge_attention_bwd_stream.launches = 0


# ---------------------------------------------------------------- pass B


def stream_to_senders(dkv_stream, tile_senders, slots, slot0: int, out, *, s, sp):
    """Pass B: ``out`` [NT, S, 2D] += the stream rows of the walked ``slots``
    (flat ids, the stream's first row being slot ``slot0``), summed by the
    slot's sender. Only walked slots are read, so unwritten rows never
    enter; masked slots add the zeros pass A wrote."""
    rows = dkv_stream.view(-1, sp, dkv_stream.shape[1])
    slots = slots.long()
    senders = tile_senders.reshape(-1)[slots].long()
    out.index_add_(0, senders, rows[slots - slot0, :s])
    return out


def stream_backward(q_rows, kv_rows, dsum_rows, tile_senders, tile_valid,
                    recv_ptr, recv_slots, *, s, sp, num_heads, softmax,
                    chunk_bytes: Optional[int] = None):
    """Pass A + pass B: (dQ rows [NT*sp, D], dK|dV per node [NT, S, 2D]).

    With ``chunk_bytes`` the tiles run in chunks whose stream fits that many
    bytes, each folded into the per-node sums before the next is made (the
    JAX package's rule for its dma gather; same work, a smaller live
    stream); None runs all tiles in one launch."""
    t, emax = tile_senders.shape
    d = q_rows.shape[1]
    nt = recv_ptr.numel() - 1
    n_chunks = 1
    if chunk_bytes:
        n_chunks = max(1, -(-t * emax * sp * 2 * d * 4 // chunk_bytes))
    tc = -(-t // n_chunks)                      # tiles per chunk
    edges = list(range(0, t, tc)) + [t]         # chunk ci = tiles [edges[ci], edges[ci+1])
    tn = nt // t
    bounds = _walk_bounds(recv_ptr, recv_slots, [e * tn for e in edges])
    dkv = torch.zeros(nt, s, 2 * d, dtype=torch.float32, device=q_rows.device)
    dq_parts = []
    for ci, (t0, t1) in enumerate(zip(edges, edges[1:])):
        dq_c, stream_c = edge_attention_bwd_stream(
            q_rows, kv_rows, dsum_rows, tile_senders, tile_valid, recv_ptr,
            recv_slots, s=s, sp=sp, num_heads=num_heads, softmax=softmax,
            tiles=(t0, t1))
        dq_parts.append(dq_c)
        stream_to_senders(stream_c, tile_senders, recv_slots[bounds[ci]: bounds[ci + 1]],
                          t0 * emax, dkv, s=s, sp=sp)
        del stream_c                            # one chunk's stream live at a time
    return (dq_parts[0] if len(dq_parts) == 1 else torch.cat(dq_parts)), dkv
