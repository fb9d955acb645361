"""Tiled-CSR edge layout for the fused Hopper edge-attention kernels.

Host numpy, copied from ``ampnet_tpu/ops/pallas/format.py`` so that both
packages build equal arrays from one graph: live edges are bucketed by
receiver tile (TN receivers per tile) and padded to a common per-tile edge
budget. Within a tile, edges keep their input order, so they are not
grouped by receiver.

The Hopper kernels run one thread block per receiver, not per tile, so
this module also derives a receiver-major index over the same slots
(``receiver_index``): the CSR pointer ``recv_ptr`` [T*TN + 1] and the
flat slots ``recv_slots`` (slot = tile * EMAX + position), in input order
within each receiver. The backward's pass S runs one block per SENDER
over the sender-tiled side, so the same function, given that side, makes
``snd_ptr``/``snd_slots``. Both are built from the STRUCTURAL layout; a
runtime edge mask reaches the kernels through the validity slots alone
(``edge_slot_valid``, ``snd_slot_valid``).

A second layout, ``ChunkedCSR`` (``build_chunked_csr``, also the JAX
package's, array for array), groups the edges into chunks of up to C that
share one receiver, for the chunked kernel. A receiver's chunks are
consecutive in its tile, so ``chunk_index`` gives that kernel's per-receiver
walk; ``chunk_slot_valid`` scatters a runtime mask into this layout's own
slot numbering.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

# Library-wide default node-tile size (the JAX package's; layouts carry
# their tile_nodes, so consumers follow whatever the builder used).
DEFAULT_TILE_NODES = 256


class TiledCSR(NamedTuple):
    senders: np.ndarray      # [T, EMAX] int32 global sender node id
    recv_local: np.ndarray   # [T, EMAX] int32 receiver row within tile
    valid: np.ndarray        # [T, EMAX] int32 0/1 edge validity
    tile_nodes: int          # TN
    num_tiles: int           # T
    edges_per_tile: int      # EMAX (multiple of lcm(group, 128))
    counts: Optional[np.ndarray] = None     # [T] int32 live edges per tile
    edge_slot: Optional[np.ndarray] = None  # [E] int32 flat slot of each input
    #                                         edge (-1 = masked): tile*EMAX+pos


def build_tiled_csr(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_mask: np.ndarray,
    num_nodes_padded: int,
    tile_nodes: int = DEFAULT_TILE_NODES,
    group: int = 8,
    edges_per_tile: int = 0,
) -> TiledCSR:
    """Pass edges_per_tile > 0 to FIX the per-tile edge budget; raises if
    any tile overflows it."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    edge_mask = np.asarray(edge_mask).astype(bool)

    tn = tile_nodes
    t = -(-num_nodes_padded // tn)

    sel = edge_mask
    s, r = senders[sel], receivers[sel]
    tile_of_edge = r // tn
    counts = np.bincount(tile_of_edge, minlength=t)
    need = int(counts.max()) if counts.size and counts.max() > 0 else group
    step = int(np.lcm(group, 128))
    if edges_per_tile:
        if need > edges_per_tile:
            raise ValueError(
                f"tile edge budget {edges_per_tile} < required {need}; "
                f"raise edges_per_tile or lower tile_nodes"
            )
        if edges_per_tile % step:
            raise ValueError(f"edges_per_tile must be a multiple of {step}")
        emax = edges_per_tile
    else:
        emax = ((need + step - 1) // step) * step
    if t * emax >= 2**31:
        # slots are int32 in the kernels; a wrapped negative slot would be
        # taken as MASKED by the runtime-mask scatter and silently drop
        # the edge — fail loudly, before anything is allocated
        raise ValueError(
            f"layout slot space {t}x{emax} overflows int32; lower "
            f"edges_per_tile or raise tile_nodes")

    out_s = np.zeros((t, emax), np.int32)
    out_r = np.zeros((t, emax), np.int32)
    out_v = np.zeros((t, emax), np.int32)
    order = np.argsort(tile_of_edge, kind="stable")
    s, r = s[order], r[order]
    starts = np.zeros(t + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    sel_ids = np.nonzero(sel)[0][order]
    slot_sorted = np.empty(len(sel_ids), np.int64)
    for ti in range(t):
        a, b = starts[ti], starts[ti + 1]
        k = b - a
        out_s[ti, :k] = s[a:b]
        out_r[ti, :k] = r[a:b] % tn
        out_v[ti, :k] = 1
        slot_sorted[a:b] = ti * emax + np.arange(k)
    edge_slot = np.full(len(senders), -1, np.int64)
    edge_slot[sel_ids] = slot_sorted
    return TiledCSR(
        out_s, out_r, out_v, tn, t, emax,
        counts=counts.astype(np.int32), edge_slot=edge_slot.astype(np.int32),
    )


class ChunkedCSR(NamedTuple):
    """Receiver-centric chunked layout: chunks of up to C edges sharing ONE
    receiver (a receiver of higher degree spans several consecutive
    chunks), receiver-major within each tile."""

    senders: np.ndarray      # [T, NCMAX*C] int32 global sender (chunk-major)
    chunk_recv: np.ndarray   # [T, NCMAX] int32 receiver row within tile
    valid: np.ndarray        # [T, NCMAX*C] int32 0/1 (may carry runtime masks)
    tile_nodes: int          # TN
    num_tiles: int           # T
    chunk_edges: int         # C
    chunks_per_tile: int     # NCMAX (multiple of 128)
    counts: Optional[np.ndarray] = None     # [T] int32 live chunks per tile
    edge_slot: Optional[np.ndarray] = None  # [E] int32 flat slot
    #                          tile * (NCMAX*C) + chunk*C + j (-1 = masked)


def build_chunked_csr(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_mask: np.ndarray,
    num_nodes_padded: int,
    tile_nodes: int = DEFAULT_TILE_NODES,
    chunk_edges: int = 8,
    chunks_per_tile: int = 0,
) -> ChunkedCSR:
    """Pass chunks_per_tile > 0 to FIX the per-tile chunk budget so
    layouts for different subgraphs share one static shape."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    edge_mask = np.asarray(edge_mask).astype(bool)

    tn = tile_nodes
    c = chunk_edges
    t = -(-num_nodes_padded // tn)

    sel = np.nonzero(edge_mask)[0]
    s, r = senders[sel], receivers[sel]
    order = np.argsort(r, kind="stable")   # receiver-major
    s, r, sel = s[order], r[order], sel[order]

    # ceil(deg / C) chunks per receiver
    deg = np.bincount(r, minlength=num_nodes_padded)
    chunks_of_recv = -(-deg // c)
    tile_of_recv = np.arange(num_nodes_padded) // tn
    chunk_counts = np.bincount(tile_of_recv, weights=chunks_of_recv,
                               minlength=t).astype(np.int64)
    need = int(chunk_counts.max()) if chunk_counts.size else 1
    if chunks_per_tile:
        if need > chunks_per_tile:
            raise ValueError(
                f"tile chunk budget {chunks_per_tile} < required {need}; "
                f"raise chunks_per_tile or lower tile_nodes"
            )
        if chunks_per_tile % 128:
            raise ValueError("chunks_per_tile must be a multiple of 128")
        ncmax = chunks_per_tile
    else:
        ncmax = ((max(need, 1) + 127) // 128) * 128

    out_s = np.zeros((t, ncmax * c), np.int32)
    out_r = np.zeros((t, ncmax), np.int32)
    out_v = np.zeros((t, ncmax * c), np.int32)
    edge_slot = np.full(len(senders), -1, np.int64)

    # walk receiver runs in order; chunks land consecutively per tile
    run_starts = np.nonzero(np.diff(r, prepend=-1))[0]
    run_ends = np.append(run_starts[1:], len(r))
    next_chunk = np.zeros(t, np.int64)
    for a, b in zip(run_starts, run_ends):
        recv = int(r[a])
        ti = recv // tn
        for off in range(a, b, c):
            k = min(c, b - off)
            ci = int(next_chunk[ti])
            next_chunk[ti] += 1
            out_r[ti, ci] = recv % tn
            out_s[ti, ci * c : ci * c + k] = s[off : off + k]
            out_v[ti, ci * c : ci * c + k] = 1
            edge_slot[sel[off : off + k]] = ti * (ncmax * c) + ci * c + np.arange(k)
    counts = next_chunk.astype(np.int32)
    return ChunkedCSR(
        out_s, out_r, out_v, tn, t, c, ncmax,
        counts=counts, edge_slot=edge_slot.astype(np.int32),
    )


def chunk_index(chunk_recv: np.ndarray, counts: np.ndarray,
                tile_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-receiver walk over a chunked layout: (chunk_start [T*TN] int32,
    chunk_count [T*TN] int32). The chunks of global receiver n are the flat
    chunks chunk_start[n] .. chunk_start[n] + chunk_count[n] - 1 (flat =
    tile * NCMAX + chunk). Raises unless each tile's live chunks are
    receiver-major, as build_chunked_csr lays them out."""
    t, ncmax = chunk_recv.shape
    live = np.arange(ncmax)[None, :] < np.asarray(counts)[:, None]
    tile_idx, ci = np.nonzero(live)                       # tile-major, chunk asc
    recv = tile_idx.astype(np.int64) * tile_nodes + chunk_recv[tile_idx, ci]
    if (np.diff(recv) < 0).any():
        raise ValueError("chunked layout is not receiver-major within its tiles")
    count = np.bincount(recv, minlength=t * tile_nodes)
    start = np.zeros(t * tile_nodes, np.int64)
    first = np.nonzero(np.diff(recv, prepend=-1))[0]      # first chunk of each run
    start[recv[first]] = tile_idx[first].astype(np.int64) * ncmax + ci[first]
    return start.astype(np.int32), count.astype(np.int32)


def receiver_index(recv_local: np.ndarray, counts: np.ndarray,
                   tile_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Receiver-major index over a tiled layout's structural slots.

    Returns (recv_ptr [T*TN + 1] int32, recv_slots [sum(counts)] int32):
    the live slots of global receiver n are
    recv_slots[recv_ptr[n]:recv_ptr[n + 1]], in input (slot) order.
    Given the sender-tiled side (snd_local, snd_counts) it is the
    sender-major index over that side's slots.
    """
    t, emax = recv_local.shape
    live = np.arange(emax)[None, :] < np.asarray(counts)[:, None]
    tile_idx, pos = np.nonzero(live)                      # tile-major, pos asc
    recv = tile_idx.astype(np.int64) * tile_nodes + recv_local[tile_idx, pos]
    order = np.argsort(recv, kind="stable")
    slots = (tile_idx.astype(np.int64) * emax + pos)[order]
    ptr = np.zeros(t * tile_nodes + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(recv, minlength=t * tile_nodes))
    return ptr.astype(np.int32), slots.astype(np.int32)


def default_edge_budget(num_edges_padded: int, num_tiles: int,
                        slack: float = 2.0, group: int = 1) -> int:
    """A safe fixed per-tile budget: slack * average edges per tile,
    rounded to lcm(group, 128) so build_tiled_csr accepts it."""
    avg = max(1, num_edges_padded // max(1, num_tiles))
    budget = int(avg * slack) + 128
    step = (128 * group) // math.gcd(128, max(group, 1))
    return ((budget + step - 1) // step) * step


def _tensors_to(layout, device):
    """A copy of a layout dataclass with its tensors on ``device``."""
    return dataclasses.replace(layout, **{
        f.name: getattr(layout, f.name).to(device)
        for f in dataclasses.fields(layout)
        if isinstance(getattr(layout, f.name), torch.Tensor)
    })


@dataclass
class EdgeLayout:
    """Device-side layout tensors handed to the fused op (int32).

    ``tile_*`` and ``edge_slot`` equal the JAX package's EdgeLayout;
    ``recv_ptr``/``recv_slots`` are the receiver-major index the Hopper
    kernels walk; ``snd_*`` is the same edges bucketed by SENDER tile, for
    the scatter-free backward, with ``snd_ptr``/``snd_slots`` the
    sender-major index its pass S walks. The live slots are the first
    ``recv_ptr[-1]`` (``snd_ptr[-1]``) of the flat slots; a layout of a
    fixed budget pads the rest with slot 0, which nothing walks."""

    tile_senders: torch.Tensor          # [T, EMAX]
    tile_recv: torch.Tensor             # [T, EMAX]
    tile_valid: torch.Tensor            # [T, EMAX] structural 0/1
    tile_counts: torch.Tensor           # [T] structural live-edge counts
    edge_slot: torch.Tensor             # [E] (-1 = masked out)
    recv_ptr: torch.Tensor              # [T*TN + 1]
    recv_slots: torch.Tensor            # [sum(tile_counts)], or [T*EMAX] at a budget
    snd_receivers: Optional[torch.Tensor] = None  # [T, EMAXS] global receiver ids
    snd_local: Optional[torch.Tensor] = None      # [T, EMAXS] local sender row
    snd_valid: Optional[torch.Tensor] = None
    snd_counts: Optional[torch.Tensor] = None
    snd_edge_slot: Optional[torch.Tensor] = None
    snd_ptr: Optional[torch.Tensor] = None        # [T*TN + 1]
    snd_slots: Optional[torch.Tensor] = None      # [sum(snd_counts)], [T*EMAXS] at a budget
    tile_nodes: int = DEFAULT_TILE_NODES

    def to(self, device) -> "EdgeLayout":
        return _tensors_to(self, device)


def _pad_slots(slots: np.ndarray, capacity: int) -> np.ndarray:
    return np.concatenate([slots, np.zeros(capacity - slots.size, np.int32)])


def compute_layout(graph, tile_nodes: int = DEFAULT_TILE_NODES,
                   edges_per_tile: int = 0, sender_layout: bool = True,
                   snd_edges_per_tile: int = 0) -> EdgeLayout:
    """Host-side layout build for a padded Graph; the tensors land on the
    graph's device. A fixed edges_per_tile budget fixes the sender-side
    budget too unless snd_edges_per_tile is given. A side of a fixed budget
    pads its slots to their capacity (T*EMAX, T*EMAXS), so that every graph
    of one padded size and budget gets the same shapes (a captured step
    replays on any of them)."""
    senders = graph.senders.cpu().numpy()
    receivers = graph.receivers.cpu().numpy()
    mask = graph.edge_mask.cpu().numpy()
    n_pad = graph.num_nodes_padded
    tcsr = build_tiled_csr(senders, receivers, mask, n_pad,
                           tile_nodes=tile_nodes, edges_per_tile=edges_per_tile)
    recv_ptr, recv_slots = receiver_index(tcsr.recv_local, tcsr.counts, tile_nodes)
    if edges_per_tile:
        recv_slots = _pad_slots(recv_slots, tcsr.senders.size)
    snd = {}
    if sender_layout:
        if edges_per_tile and not snd_edges_per_tile:
            snd_edges_per_tile = edges_per_tile
        # the SAME edges bucketed by sender: roles swapped
        stcsr = build_tiled_csr(receivers, senders, mask, n_pad,
                                tile_nodes=tile_nodes,
                                edges_per_tile=snd_edges_per_tile)
        snd_ptr, snd_slots = receiver_index(stcsr.recv_local, stcsr.counts, tile_nodes)
        if snd_edges_per_tile:
            snd_slots = _pad_slots(snd_slots, stcsr.senders.size)
        snd = dict(snd_receivers=stcsr.senders, snd_local=stcsr.recv_local,
                   snd_valid=stcsr.valid, snd_counts=stcsr.counts,
                   snd_edge_slot=stcsr.edge_slot, snd_ptr=snd_ptr,
                   snd_slots=snd_slots)
    arrays = dict(tile_senders=tcsr.senders, tile_recv=tcsr.recv_local,
                  tile_valid=tcsr.valid, tile_counts=tcsr.counts,
                  edge_slot=tcsr.edge_slot, recv_ptr=recv_ptr,
                  recv_slots=recv_slots, **snd)
    device = graph.senders.device
    return EdgeLayout(
        **{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in arrays.items()},
        tile_nodes=tile_nodes,
    )


@dataclass
class ChunkedLayout:
    """Device-side chunked layout handed to the chunked kernel (int32):
    ``build_chunked_csr``'s arrays and ``chunk_index``'s walk over them."""

    senders: torch.Tensor        # [T, NCMAX*C]
    chunk_recv: torch.Tensor     # [T, NCMAX]
    valid: torch.Tensor          # [T, NCMAX*C] structural 0/1
    counts: torch.Tensor         # [T] live chunks per tile
    edge_slot: torch.Tensor      # [E] (-1 = masked out)
    chunk_start: torch.Tensor    # [T*TN]
    chunk_count: torch.Tensor    # [T*TN]
    chunk_edges: int = 8
    tile_nodes: int = DEFAULT_TILE_NODES

    def to(self, device) -> "ChunkedLayout":
        return _tensors_to(self, device)


def compute_chunked_layout(graph, tile_nodes: int = DEFAULT_TILE_NODES,
                           chunk_edges: int = 8,
                           chunks_per_tile: int = 0) -> ChunkedLayout:
    """Host-side chunked layout build for a padded Graph; the tensors land
    on the graph's device."""
    ck = build_chunked_csr(
        graph.senders.cpu().numpy(), graph.receivers.cpu().numpy(),
        graph.edge_mask.cpu().numpy(), graph.num_nodes_padded,
        tile_nodes=tile_nodes, chunk_edges=chunk_edges,
        chunks_per_tile=chunks_per_tile)
    start, count = chunk_index(ck.chunk_recv, ck.counts, tile_nodes)
    arrays = dict(senders=ck.senders, chunk_recv=ck.chunk_recv, valid=ck.valid,
                  counts=ck.counts, edge_slot=ck.edge_slot, chunk_start=start,
                  chunk_count=count)
    device = graph.senders.device
    return ChunkedLayout(
        **{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in arrays.items()},
        chunk_edges=chunk_edges, tile_nodes=tile_nodes)


def _scatter_mask(edge_slot: torch.Tensor, shape, edge_mask: torch.Tensor) -> torch.Tensor:
    t, emax = shape
    slot = edge_slot.long()
    slot = torch.where(slot < 0, torch.full_like(slot, t * emax), slot)
    flat = torch.zeros(t * emax + 1, dtype=torch.int32, device=slot.device)
    flat[slot] = edge_mask.to(torch.int32)
    return flat[:-1].reshape(t, emax)


def edge_slot_valid(layout: EdgeLayout, edge_mask: torch.Tensor) -> torch.Tensor:
    """Scatter a RUNTIME edge mask into the layout's validity slots
    ([T, EMAX] int32); masked and pad slots read 0. Trip counts stay
    structural (recv_ptr), so a dropped edge is walked and weighted 0."""
    return _scatter_mask(layout.edge_slot, layout.tile_valid.shape, edge_mask)


def snd_slot_valid(layout: EdgeLayout, edge_mask: torch.Tensor) -> torch.Tensor:
    """The same scatter into the SENDER-tiled side's validity slots
    ([T, EMAXS] int32), for the backward's pass S."""
    return _scatter_mask(layout.snd_edge_slot, layout.snd_valid.shape, edge_mask)


def chunk_slot_valid(layout: ChunkedLayout, edge_mask: torch.Tensor) -> torch.Tensor:
    """The same scatter into the chunked layout's validity slots
    ([T, NCMAX*C] int32; slot = tile*(NCMAX*C) + chunk*C + j). The chunks
    stay structural, so a dropped edge leaves a hole in its chunk."""
    return _scatter_mask(layout.edge_slot, layout.valid.shape, edge_mask)
