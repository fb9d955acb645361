"""Stream backward of the fused edge attention on Hopper: pass A and pass B
of the JAX package's ``ops/pallas/edge_attention_bwd.py``, for layouts that
have no sender side to walk (``compute_layout(sender_layout=False)``) and
for ``scatterfree=False``.

One hand-written kernel beside its plain torch version, with two bodies
(``launch.body``, K3's rule): on the tensor cores in 3xTF32
(``csrc/edge_attention_bwd_stream_tc.cu``, K3's receiver design with the
transposed products through a staging tile per head) within K3's range, and
on the CUDA cores (``csrc/edge_attention_bwd.cu``, the third instantiation
of the body K3 and K4 share there) beyond it, at any shape, its working set
in device memory where it exceeds a block's shared memory:

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
package: take the WALKED slots' rows (chosen by a device mask, no host
read) and sum them by sender in a fixed order (``ops/segment.py``'s
``segment_sum_into``, the sorted sum on the card), so dK|dV repeat bit for
bit from run to run, as K4's (the scatter-free pass S) do. ``stream_backward`` runs both passes over chunks of tiles so that the
live stream stays under a byte budget (``AMPNET_STREAM_CHUNK_BYTES``,
default 1 GiB, the JAX package's rule).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. The wrapper counts its launches in
``edge_attention_bwd_stream.launches``, by body in ``.body_launches``.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ampnet_tpu_torch.ops.hopper.edge_attention_bwd_scatterfree import (
    _merge,
    _recompute,
    _walk,
)
from ampnet_tpu_torch.ops.hopper.launch import (
    BODIES,
    I,
    P,
    body_of,
    check_f32_rows,
    check_walk,
    count_launch,
    entry,
    launch_body,
)
from ampnet_tpu_torch.ops.segment import segment_sum_into

# (library, entry point, signature) of each body; the CUDA-core one also
# takes its device-memory working set (pointer, blocks) before the stream
_SIGNATURE = [P, I, P, I, P, I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P]
_BODIES = {"tc": ("edge_attention_bwd_stream_tc", "ampnet_edge_attention_bwd_stream",
                  _SIGNATURE),
           "simt": ("edge_attention_bwd", "ampnet_edge_attention_bwd_stream_simt",
                    _SIGNATURE[:-1] + [P, I, P])}

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
    a, b = recv_ptr[[n0, n1]].tolist()          # a host read: the CPU only
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
                              tiles: Optional[Tuple[int, int]] = None,
                              body: Optional[str] = None):
    """K5, pass A over the receivers of tiles [t0, t1) (default: all):
    (dQ rows [(t1-t0)*TN*sp, D], dK|dV stream [(t1-t0)*EMAX*sp, 2D]), f32.

    q_rows, dsum_rows [NT*sp, D] and kv_rows [NT*sp, 2D] are the WHOLE
    graph's rows and may be row-strided views; dsum is the gradient of the
    per-receiver SUM of messages. The index arrays are int32 (format.py);
    tile_valid may carry a runtime mask. The stream holds sp rows per slot
    of the range, the first being slot t0*EMAX; rows of slots that are not
    walked are not written. The body is K3's rule (``launch.body_of`` on
    kv_rows, which the tensor-core body gathers in 16-byte copies; ``body``
    names one). CPU tensors run the plain version."""
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
    body = body_of("edge_attention_bwd_stream", body, s, d, num_heads, ("kv_rows", kv_rows))
    nodes = (t1 - t0) * tn
    dq = torch.empty(nodes * sp, d, dtype=torch.float32, device=dev)
    out = torch.empty((t1 - t0) * emax * sp, 2 * d, dtype=torch.float32, device=dev)
    lib, fn, signature = _BODIES[body]
    launch_body("edge_attention_bwd_stream", body, entry(lib, fn, signature), (
        q_rows.data_ptr(), q_rows.stride(0), dsum_rows.data_ptr(), dsum_rows.stride(0),
        kv_rows.data_ptr(), kv_rows.stride(0), tile_senders.data_ptr(),
        tile_valid.data_ptr(), recv_ptr.data_ptr(), recv_slots.data_ptr(), dq.data_ptr(),
        out.data_ptr(), t0 * tn, nodes, t0 * emax, s, sp, d, num_heads, int(softmax)),
        s, d, num_heads, nodes, dev)
    count_launch(edge_attention_bwd_stream, body)
    return dq, out


edge_attention_bwd_stream.launches = 0
edge_attention_bwd_stream.body_launches = dict.fromkeys(BODIES, 0)


# ---------------------------------------------------------------- pass B


def walked_slots(tile_senders, recv_ptr, tiles: Tuple[int, int]) -> torch.Tensor:
    """[(t1-t0)*EMAX] bool: the slots of tiles [t0, t1) that pass A walks. A
    tile walks its first ``count`` slots, ``count`` being its receivers'
    edges (``recv_ptr`` at the tile's ends), so the mask is made on the
    device from ``recv_ptr`` alone: no host read, and the padding of a
    fixed-capacity ``recv_slots`` is never looked at."""
    t0, t1, tn, emax = _tile_range(tile_senders, recv_ptr, tiles)
    ends = recv_ptr[t0 * tn: t1 * tn + 1: tn]
    count = (ends[1:] - ends[:-1])[:, None]
    return (torch.arange(emax, device=recv_ptr.device) < count).reshape(-1)


def stream_to_senders(dkv_stream, tile_senders, take, slot0: int, out, *, s, sp):
    """Pass B: ``out`` [NT, S, 2D] += the stream rows (slot ``slot0`` and the
    ones after it, one per stream slot) where ``take`` holds, summed by the
    slot's sender in a fixed order (``segment_sum_into``: on the card the
    sorted sum, so a step repeats bit for bit, as the reference's XLA
    segment sum does). The other rows (never written: they may hold NaN)
    are selected away, not multiplied away. Masked slots add the zeros pass
    A wrote. Its work and memory are the stream's: one chunk's, never the
    graph's."""
    rows = dkv_stream.view(-1, sp, dkv_stream.shape[1])[:, :s]
    senders = tile_senders.reshape(-1)[slot0: slot0 + rows.shape[0]]
    return segment_sum_into(out, rows, senders, take)


def stream_backward(q_rows, kv_rows, dsum_rows, tile_senders, tile_valid,
                    recv_ptr, recv_slots, *, s, sp, num_heads, softmax,
                    chunk_bytes: Optional[int] = None):
    """Pass A + pass B: (dQ rows [NT*sp, D], dK|dV per node [NT, S, 2D]).

    With ``chunk_bytes`` the tiles run in chunks whose stream fits that many
    bytes, each folded into the per-node sums before the next is made (the
    JAX package's rule for its dma gather; same work, a smaller live
    stream); None runs all tiles in one launch. Pass B takes each chunk's
    walked slots from a device mask (``walked_slots``), so nothing is read
    back to the host and a fixed-capacity layout's shapes stay fixed."""
    t, emax = tile_senders.shape
    d = q_rows.shape[1]
    nt = recv_ptr.numel() - 1
    n_chunks = 1
    if chunk_bytes:
        n_chunks = max(1, -(-t * emax * sp * 2 * d * 4 // chunk_bytes))
    tc = -(-t // n_chunks)                      # tiles per chunk
    edges = list(range(0, t, tc)) + [t]         # chunk ci = tiles [edges[ci], edges[ci+1])
    dkv = torch.zeros(nt, s, 2 * d, dtype=torch.float32, device=q_rows.device)
    dq_parts = []
    for t0, t1 in zip(edges, edges[1:]):
        dq_c, stream_c = edge_attention_bwd_stream(
            q_rows, kv_rows, dsum_rows, tile_senders, tile_valid, recv_ptr,
            recv_slots, s=s, sp=sp, num_heads=num_heads, softmax=softmax,
            tiles=(t0, t1))
        dq_parts.append(dq_c)
        stream_to_senders(stream_c, tile_senders, walked_slots(tile_senders, recv_ptr, (t0, t1)),
                          t0 * emax, dkv, s=s, sp=sp)
        del stream_c                            # one chunk's stream live at a time
    return (dq_parts[0] if len(dq_parts) == 1 else torch.cat(dq_parts)), dkv
