"""Edge-partitioned (graph-sharded) AMPGCN training over ``torch.distributed``
(``ampnet_tpu/parallel/edge_partition.py`` in torch).

  * nodes are partitioned into contiguous blocks over the mesh's 'graph'
    axis (global id = shard * N_loc + local id);
  * each edge lives on the shard that owns its RECEIVER, so the mean
    aggregation is local;
  * the K|V-projected tokens cross the shards (after the projection: D
    columns, not F). Two exchanges: the all-gather of every projected row
    (``collectives.all_gather_rows``, backward a reduce-scatter), or the
    boundary-only halo (``build_halo_plan``): one point-to-point exchange
    per live ring offset of just the rows the destination's edges name
    (``halo_exchange``, backward the reverse exchange and a scatter-add
    into the owner's rows).

The host side (``partition_graph``, ``build_halo_plan``,
``common_halo_meta``, ``partition_layouts``, the ``stack_*`` helpers) is
numpy and gives the JAX package's arrays bit for bit; ``partition_layouts``
adds the port's walk of each side (``format.receiver_index``). Each rank
takes its slice (``.local(index, device)``).

The local forward mirrors ``models/amp_gcn.py`` with the model's own
parameters, deterministic (no dropout), as the JAX package's: batch
statistics and TF-IDF document frequencies summed over 'graph' with
``all_reduce``. With a layout the convs' attention runs
``fused_attention_aggregate`` (K1 forward; K3 + K4, or K5 + pass B,
backward) with K|V rows over the local-plus-halo (or all-gathered) axis.

The steps differentiate each rank's own share of the loss (its nodes' part
of the sum, over the global denominators), then sum the parameter gradients
over the world: back-propagating an already all-reduced loss would make
them P times too large. They run eager: gloo collectives cannot be captured
into a CUDA graph.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ampnet_tpu_torch.ops.edge_attention import attention_core
from ampnet_tpu_torch.ops.hopper.edge_attention_fused import fused_attention_aggregate
from ampnet_tpu_torch.ops.hopper.format import (
    DEFAULT_TILE_NODES,
    _pad_slots,
    build_tiled_csr,
    receiver_index,
)
from ampnet_tpu_torch.ops.segment import segment_count, segment_sum, segment_sum_into
from ampnet_tpu_torch.ops.tokenize import (
    gather_tokens,
    sample_present_features,
    tfidf_sample_features,
)
from ampnet_tpu_torch.parallel.collectives import (
    all_gather_rows,
    all_reduce,
    all_reduce_grads,
    ring_exchange,
    ring_exchange_rows,
)
from ampnet_tpu_torch.parallel.mesh import Mesh


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pick(a: np.ndarray, index: Tuple[int, ...], device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a[index])).to(device=device, dtype=dtype)


@dataclass
class Shard:
    """One rank's slice of a PartitionedGraph, on its device."""

    x: torch.Tensor                # [N_loc, F]
    y: torch.Tensor                # [N_loc] int64
    node_mask: torch.Tensor        # [N_loc] bool
    train_mask: torch.Tensor
    test_mask: torch.Tensor
    node_norm: torch.Tensor        # [N_loc] f32
    senders_global: torch.Tensor   # [E_loc] int64 (global node ids)
    receivers_local: torch.Tensor  # [E_loc] int64 (local node ids)
    edge_mask: torch.Tensor        # [E_loc] bool


class PartitionedGraph(NamedTuple):
    """Per-shard numpy arrays, stacked on a leading shard axis (two,
    [data, graph], after ``stack_partitioned``)."""

    x: np.ndarray              # [P, N_loc, F]
    y: np.ndarray              # [P, N_loc]
    node_mask: np.ndarray      # [P, N_loc]
    train_mask: np.ndarray     # [P, N_loc]
    test_mask: np.ndarray      # [P, N_loc]
    node_norm: np.ndarray      # [P, N_loc]
    senders_global: np.ndarray   # [P, E_loc] int32 (global node ids)
    receivers_local: np.ndarray  # [P, E_loc] int32 (local node ids)
    edge_mask: np.ndarray        # [P, E_loc]

    @property
    def num_shards(self) -> int:
        return self.x.shape[0]

    def local(self, index: Tuple[int, ...], device) -> Shard:
        dt = (torch.float32, torch.int64, torch.bool, torch.bool, torch.bool,
              torch.float32, torch.int64, torch.int64, torch.bool)
        return Shard(*(_pick(a, index, device, t) for a, t in zip(self, dt)))


def partition_graph(g, n_shards: int) -> PartitionedGraph:
    """Host-side partitioner: contiguous node blocks; edges by receiver."""
    n_pad = g.num_nodes_padded
    n_loc = -(-n_pad // n_shards)
    n_tot = n_loc * n_shards

    def pad_nodes(a, fill):
        a = _np(a)
        out = np.full((n_tot,) + a.shape[1:], fill, dtype=a.dtype)
        out[: a.shape[0]] = a
        return out.reshape((n_shards, n_loc) + a.shape[1:])

    senders = _np(g.senders)
    receivers = _np(g.receivers)
    emask = _np(g.edge_mask)
    shard_of_edge = receivers // n_loc
    counts = np.bincount(shard_of_edge[emask], minlength=n_shards)
    e_loc = max(int(counts.max()) if counts.size else 1, 1)
    e_loc = ((e_loc + 127) // 128) * 128

    sg = np.zeros((n_shards, e_loc), np.int32)
    rl = np.zeros((n_shards, e_loc), np.int32)
    em = np.zeros((n_shards, e_loc), bool)
    for p in range(n_shards):
        sel = emask & (shard_of_edge == p)
        k = int(sel.sum())
        sg[p, :k] = senders[sel]
        rl[p, :k] = receivers[sel] % n_loc
        em[p, :k] = True

    zeros = np.zeros(n_pad, np.int32)
    return PartitionedGraph(
        x=pad_nodes(g.x, 0.0),
        y=pad_nodes(_np(g.y) if g.y is not None else zeros, 0),
        node_mask=pad_nodes(g.node_mask, False),
        train_mask=pad_nodes(_np(g.train_mask) if g.train_mask is not None
                             else zeros.astype(bool), False),
        test_mask=pad_nodes(_np(g.test_mask) if g.test_mask is not None
                            else zeros.astype(bool), False),
        node_norm=pad_nodes(_np(g.node_norm) if g.node_norm is not None
                            else np.ones(n_pad, np.float32), 0.0),
        senders_global=sg,
        receivers_local=rl,
        edge_mask=em,
    )


class LocalHalo(NamedTuple):
    """One rank's halo plan on its device."""
    send_idx: torch.Tensor      # [sum(H_o)] int64, my rows offset-major
    senders_ext: torch.Tensor   # [E_loc] int64 into local + halo
    meta: tuple                 # (offsets, sizes)


class HaloPlan:
    """Host-precomputed boundary-exchange plan (arrays stacked on a leading
    shard axis). For each ordered shard pair (src p -> dst q) the rows of p
    that q's edges reference are enumerated once (sorted unique); pairs are
    grouped by ring offset o = (q - p) mod P, each offset with its own
    budget H_o = max over its pairs (rounded to pad_to); offsets nobody
    needs are dropped. ``senders_ext`` remaps every edge's global sender id
    into the [N_loc + sum(H_o)) local+halo space (offset-major blocks after
    the local rows)."""

    def __init__(self, send_idx, senders_ext, pair_counts, offsets, sizes):
        self.send_idx = send_idx        # [P, sum(H_o)] int32, offset-major
        self.senders_ext = senders_ext  # [P, E_loc] int32 into local+halo
        self.pair_counts = pair_counts  # [P, P] int32 [dst, src] true sizes
        self.offsets = tuple(int(o) for o in offsets)
        self.sizes = tuple(int(s) for s in sizes)

    @property
    def halo_width(self) -> int:
        """Total halo rows per shard (sum of all offset blocks)."""
        return int(sum(self.sizes))

    @property
    def meta(self):
        return (self.offsets, self.sizes)

    def local(self, index: Tuple[int, ...], device) -> LocalHalo:
        return LocalHalo(_pick(self.send_idx, index, device, torch.int64),
                         _pick(self.senders_ext, index, device, torch.int64), self.meta)


def build_halo_plan(pg: PartitionedGraph, pad_to: int = 8, force_meta=None) -> HaloPlan:
    """Host-side: per ordered shard pair, the boundary rows the
    destination's edges reference, a budget per ring offset, and the
    senders remapped into the local+halo space. ``force_meta`` = (offsets,
    sizes) pins the structure (per-replica plans stackable,
    ``stack_halos``); raises if a pair outgrows its forced budget."""
    p_shards = pg.num_shards
    n_loc = pg.x.shape[1]
    sg = np.asarray(pg.senders_global)
    em = np.asarray(pg.edge_mask)

    needed = [[np.zeros(0, np.int64)] * p_shards for _ in range(p_shards)]
    off_need = np.zeros(p_shards, np.int64)
    for q in range(p_shards):
        s_q = sg[q][em[q]]
        owners = s_q // n_loc
        for p in range(p_shards):
            if p == q:
                continue
            rows = np.unique(s_q[owners == p] % n_loc)
            needed[q][p] = rows
            o = (q - p) % p_shards
            off_need[o] = max(off_need[o], rows.size)

    if force_meta is not None:
        offsets = tuple(int(o) for o in force_meta[0])
        sizes = tuple(int(s) for s in force_meta[1])
        budget = dict(zip(offsets, sizes))
        for o in range(1, p_shards):
            if off_need[o] > budget.get(o, 0):
                raise ValueError(
                    f"force_meta budget too small for offset {o}: need "
                    f"{int(off_need[o])}, have {budget.get(o, 0)}")
    else:
        offsets = tuple(o for o in range(1, p_shards) if off_need[o] > 0)
        sizes = tuple(-(-int(off_need[o]) // pad_to) * pad_to for o in offsets)
    h_sum = int(sum(sizes))
    base = {}
    acc = 0
    for o, hh in zip(offsets, sizes):
        base[o] = acc
        acc += hh

    send_idx = np.zeros((p_shards, max(h_sum, 1)), np.int32)
    pair_counts = np.zeros((p_shards, p_shards), np.int32)
    for q in range(p_shards):
        for p in range(p_shards):
            rows = needed[q][p]
            pair_counts[q, p] = rows.size
            if p == q or rows.size == 0:
                continue
            o = (q - p) % p_shards
            send_idx[p, base[o]: base[o] + rows.size] = rows

    senders_ext = np.zeros_like(sg)
    for q in range(p_shards):
        s_q = sg[q]
        owners = s_q // n_loc
        loc = s_q % n_loc
        ext = np.where(owners == q, loc, 0).astype(np.int32)
        for p in range(p_shards):
            if p == q:
                continue
            sel = em[q] & (owners == p)
            if sel.any():
                o = (q - p) % p_shards
                pos = np.searchsorted(needed[q][p], loc[sel])
                ext[sel] = (n_loc + base[o] + pos).astype(np.int32)
        senders_ext[q] = ext

    return HaloPlan(send_idx, senders_ext, pair_counts, offsets, sizes)


def halo_exchange(x_local: torch.Tensor, send_idx_local: torch.Tensor, meta,
                  mesh: Mesh, axis: str = "graph") -> torch.Tensor:
    """Boundary-only exchange: gather my boundary rows once, then one
    point-to-point exchange per live ring offset (shard i -> shard (i+o)
    mod P); the received blocks follow the local rows offset-major ->
    [N_loc + sum(H_o), ...]. Backward: the reverse exchange, then the
    gather's scatter-add into the local rows."""
    offsets, sizes = meta
    if not offsets:
        return x_local
    buf = x_local[send_idx_local[: sum(sizes)]]
    return torch.cat([x_local, ring_exchange(buf, mesh, offsets, sizes, axis)])


class LocalLayout(NamedTuple):
    """One rank's layout on its device (int32): the receiver side over the
    N_loc local rows (senders into the exchanged K|V axis) and the sender
    side over the Tg tiles of that axis (local receiver ids)."""
    tile_senders: torch.Tensor
    tile_valid: torch.Tensor
    recv_ptr: torch.Tensor
    recv_slots: torch.Tensor
    snd_receivers: torch.Tensor
    snd_valid: torch.Tensor
    snd_ptr: torch.Tensor
    snd_slots: torch.Tensor


class ShardLayout(NamedTuple):
    """Per-shard tiled-CSR layouts, leaves stacked on a leading shard axis:
    the JAX package's six arrays, and the port's walk of each side
    (``format.receiver_index``; slots padded to the fixed budget's
    capacity so that the shards stack)."""

    tile_senders: np.ndarray   # [P, T, EMAX] sender rows of K|V
    tile_recv: np.ndarray      # [P, T, EMAX] local receiver row within tile
    tile_valid: np.ndarray     # [P, T, EMAX]
    snd_receivers: np.ndarray  # [P, Tg, EMAXS] local receiver ids
    snd_local: np.ndarray      # [P, Tg, EMAXS] sender row within its tile
    snd_valid: np.ndarray      # [P, Tg, EMAXS]
    recv_ptr: np.ndarray       # [P, T*TN + 1]
    recv_slots: np.ndarray     # [P, T*EMAX]
    snd_ptr: np.ndarray        # [P, Tg*TN + 1]
    snd_slots: np.ndarray      # [P, Tg*EMAXS]

    def local(self, index: Tuple[int, ...], device) -> LocalLayout:
        names = ("tile_senders", "tile_valid", "recv_ptr", "recv_slots",
                 "snd_receivers", "snd_valid", "snd_ptr", "snd_slots")
        return LocalLayout(*(_pick(getattr(self, k), index, device, torch.int32)
                             for k in names))


def partition_layouts(
    pg: PartitionedGraph,
    tile_nodes: int = DEFAULT_TILE_NODES,
    edges_per_tile: int = 0,
    halo_plan: Optional[HaloPlan] = None,
) -> ShardLayout:
    """Host-side: each shard's tiled CSR from its (senders, receivers_local)
    edge list, and the transposed (sender-tiled) layout for the scatter-free
    backward. The gather column indexes the all-gathered [N_tot) axis, or
    with ``halo_plan`` the [N_loc + sum(H_o)) local+halo axis. One
    edges_per_tile (default: the largest need over both bucketings and
    every shard, rounded to 128) keeps one shape across shards."""
    p = pg.num_shards
    n_loc = pg.x.shape[1]
    if halo_plan is not None:
        n_all = n_loc + halo_plan.halo_width
        senders_arr = np.asarray(halo_plan.senders_ext)
    else:
        n_all = p * n_loc
        senders_arr = np.asarray(pg.senders_global)
    if not edges_per_tile:
        need = 0
        for i in range(p):
            em = np.asarray(pg.edge_mask[i])
            r = np.asarray(pg.receivers_local[i])[em]
            sg = senders_arr[i][em]
            if r.size:
                counts = np.bincount(r // tile_nodes, minlength=-(-n_loc // tile_nodes))
                scounts = np.bincount(sg // tile_nodes, minlength=-(-n_all // tile_nodes))
                need = max(need, int(counts.max()), int(scounts.max()))
        edges_per_tile = max(128, -(-max(need, 1) // 128) * 128)
    cols = {k: [] for k in ShardLayout._fields}
    for i in range(p):
        rl, em = np.asarray(pg.receivers_local[i]), np.asarray(pg.edge_mask[i])
        tcsr = build_tiled_csr(senders_arr[i], rl, em, n_loc,
                               tile_nodes=tile_nodes, edges_per_tile=edges_per_tile)
        stcsr = build_tiled_csr(rl, senders_arr[i], em, n_all,
                                tile_nodes=tile_nodes, edges_per_tile=edges_per_tile)
        ptr, slots = receiver_index(tcsr.recv_local, tcsr.counts, tile_nodes)
        sptr, sslots = receiver_index(stcsr.recv_local, stcsr.counts, tile_nodes)
        for k, v in (("tile_senders", tcsr.senders), ("tile_recv", tcsr.recv_local),
                     ("tile_valid", tcsr.valid), ("snd_receivers", stcsr.senders),
                     ("snd_local", stcsr.recv_local), ("snd_valid", stcsr.valid),
                     ("recv_ptr", ptr), ("recv_slots", _pad_slots(slots, tcsr.senders.size)),
                     ("snd_ptr", sptr), ("snd_slots", _pad_slots(sslots, stcsr.senders.size))):
            cols[k].append(np.asarray(v, np.int32))
    return ShardLayout(*(np.stack(cols[k]) for k in ShardLayout._fields))


def _sharded_amp_conv(tokens_local, shard: Shard, conv, num_heads: int, softmax: bool,
                      mesh: Mesh, axis: str = "graph", layout: Optional[LocalLayout] = None,
                      tile_nodes: int = DEFAULT_TILE_NODES,
                      halo: Optional[LocalHalo] = None) -> torch.Tensor:
    """One AMPConv (``conv``'s parameters) with the boundary exchange over
    ``axis``: all-gather of the projected K|V rows, or the halo exchange;
    with ``layout`` the attention and sum run ``fused_attention_aggregate``."""
    n_loc, s, d = tokens_local.shape
    qkv = tokens_local @ conv.w_qkv + conv.b_qkv
    q_nodes = qkv[..., :d]
    kv_local = qkv[..., d:]                       # [N_loc, S, 2D] packed k|v
    if halo is not None:
        kv_all = halo_exchange(kv_local, halo.send_idx, halo.meta, mesh, axis)
        senders_ref = halo.senders_ext
    else:
        kv_all = all_gather_rows(kv_local, mesh, axis)
        senders_ref = shard.senders_global
    count = segment_count(shard.receivers_local, n_loc, shard.edge_mask)
    if layout is not None:
        total = fused_attention_aggregate(
            q_nodes, kv_all, layout.tile_senders, layout.tile_valid, layout.recv_ptr,
            layout.recv_slots, num_heads=num_heads, softmax=softmax, tile_nodes=tile_nodes,
            snd_receivers=layout.snd_receivers, snd_valid=layout.snd_valid,
            snd_ptr=layout.snd_ptr, snd_slots=layout.snd_slots)
    else:
        q = q_nodes[shard.receivers_local]
        kv_e = kv_all[senders_ref]
        msg, _ = attention_core(q, kv_e[..., :d], kv_e[..., d:], num_heads, softmax=softmax)
        total = segment_sum(msg, shard.receivers_local, n_loc, shard.edge_mask)
    mean = total / count.clamp_min(1.0)[:, None, None]
    out = mean @ conv.w_out + conv.b_out
    return torch.where((count > 0)[:, None, None], out, torch.zeros_like(out))


# the lean conv's chunks: a node or edge chunk holds about this many bytes
# of [rows, S, 2D] rows
LEAN_CHUNK_BYTES = 64 * 1024 * 1024


class _LeanEnv(NamedTuple):
    """What a lean conv needs beside its tensors."""
    shard: Shard
    halo: LocalHalo
    mesh: Mesh
    axis: str
    num_heads: int
    softmax: bool
    pool: bool                  # relu, then the mean over tokens (conv2); else relu (conv1)
    sampled_idx: Optional[torch.Tensor]   # conv1: its tokens' draw
    count: torch.Tensor         # [N_loc] live in-degree


def _spans(n: int, s: int, d: int):
    """[a, b) chunks of n node or edge rows, LEAN_CHUNK_BYTES of [S, 2D]
    f32 rows each."""
    rows = max(LEAN_CHUNK_BYTES // (s * 2 * d * 4), 1)
    return [(a, min(a + rows, n)) for a in range(0, n, rows)]


def _lean_input(h, x_norm, table, env: _LeanEnv, rows, grad: bool = False):
    """X[rows], the conv's input rows: rows of ``h``, or (conv1, h None)
    its tokens rebuilt from x_norm, the draw and the table. With ``grad``,
    (X, leaf): X differentiable in the leaf its gradient goes to, h's rows
    or the table (x_norm is data)."""
    if h is not None:
        x = h[rows]
        if grad:
            x = x.detach().requires_grad_()
            return x, x
        return x
    if not grad:
        return gather_tokens(x_norm[rows], env.sampled_idx[rows], table)
    leaf = table.detach().requires_grad_()
    return gather_tokens(x_norm[rows], env.sampled_idx[rows], leaf), leaf


def _lean_sums(h, x_norm, table, w_qkv, b_qkv, env: _LeanEnv):
    """(K|V [N_all, S, 2D], the per-receiver sums [N_loc, S, D]): the local
    K|V projected in node chunks into the head of one buffer, the halo rows
    received into its tail, then the attention in edge chunks (Q projected
    per edge from the receiver's input rows) added into the sums."""
    sh, n_loc = env.shard, env.count.shape[0]
    d = w_qkv.shape[0]
    s = h.shape[1] if h is not None else env.sampled_idx.shape[1]
    offsets, sizes = env.halo.meta
    kv = torch.empty(n_loc + sum(sizes), s, 2 * d, dtype=w_qkv.dtype, device=w_qkv.device)
    for a, b in _spans(n_loc, s, d):
        torch.matmul(_lean_input(h, x_norm, table, env, slice(a, b)), w_qkv[:, d:], out=kv[a:b])
        kv[a:b] += b_qkv[d:]
    if offsets:
        kv[n_loc:] = ring_exchange_rows(kv[env.halo.send_idx[: sum(sizes)]], env.mesh, offsets,
                                        sizes, env.axis)
    total = torch.zeros(n_loc, s, d, dtype=kv.dtype, device=kv.device)
    for a, b in _spans(sh.receivers_local.shape[0], s, d):
        recv = sh.receivers_local[a:b]
        q = _lean_input(h, x_norm, table, env, recv) @ w_qkv[:, :d] + b_qkv[:d]
        kve = kv[env.halo.senders_ext[a:b]]
        msg, _ = attention_core(q, kve[..., :d], kve[..., d:], env.num_heads,
                                softmax=env.softmax)
        segment_sum_into(total, msg, recv, sh.edge_mask[a:b])
    return kv, total


def _lean_finish(total, a, b, w_out, b_out, env: _LeanEnv):
    """The conv's output rows [a, b) before the relu: the mean over live
    in-edges times w_out plus b_out, 0 where no edge is live."""
    cnt = env.count[a:b][:, None, None]
    mean = total[a:b] / cnt.clamp_min(1.0)
    return mean, torch.where(cnt > 0, mean @ w_out + b_out, mean.new_zeros(()))


class _LeanHaloConv(torch.autograd.Function):
    """One AMPConv with the halo exchange, the plain attention and relu
    (conv2: then the mean over tokens) whose working set stays near its K|V
    buffer: the step with ``remat``. It keeps only its input (conv1: x_norm,
    the draw and the table, from which it rebuilds the tokens) and
    recomputes the rest in the backward, in node and edge chunks of
    LEAN_CHUNK_BYTES: no packed q|k|v, no per-edge rows beyond a chunk, the
    mean, out-projection and zero-degree mask per node chunk, the sums'
    buffer reused for the output and then for dsum. The backward holds the
    input, K|V and dK|V (the halo rows' gradients sent back by the reverse
    exchange, then added into their owners' rows), dsum and the input's
    gradient. The exchanges run in the same order on every rank: the
    forward's, then in the backward the forward's again and its reverse."""

    @staticmethod
    def forward(ctx, w_qkv, b_qkv, w_out, b_out, h, x_norm, table, env):
        ctx.env = env
        ctx.save_for_backward(w_qkv, b_qkv, w_out, b_out, h, x_norm, table)
        kv, out = _lean_sums(h, x_norm, table, w_qkv, b_qkv, env)
        del kv
        for a, b in _spans(*out.shape):
            out[a:b] = torch.relu(_lean_finish(out, a, b, w_out, b_out, env)[1])
        return out.mean(dim=1) if env.pool else out

    @staticmethod
    def backward(ctx, g):
        w_qkv, b_qkv, w_out, b_out, h, x_norm, table = ctx.saved_tensors
        env = ctx.env
        sh, n_loc, d = env.shard, env.count.shape[0], w_qkv.shape[0]
        grads = [torch.zeros_like(t) if t is not None else None
                 for t in (w_qkv, b_qkv, w_out, b_out, h, None, table)]
        dw_qkv, db_qkv, dw_out, db_out, dh, _, dtable = grads

        def push(got, rows):
            """The input rows' gradients into h's rows, or the table's."""
            if h is None:
                dtable.add_(got)
            elif isinstance(rows, slice):
                dh[rows] += got
            else:
                segment_sum_into(dh, got, rows)

        with torch.no_grad():
            kv, dsum = _lean_sums(h, x_norm, table, w_qkv, b_qkv, env)
            s = kv.shape[1]
            for a, b in _spans(n_loc, s, d):  # the finish again, its backward; dsum in place
                mean, y = _lean_finish(dsum, a, b, w_out, b_out, env)
                gy = (g[a:b, None, :] / s if env.pool else g[a:b]) * (y > 0)
                dw_out += mean.reshape(-1, d).T @ gy.reshape(-1, d)
                db_out += gy.sum(dim=(0, 1))
                dsum[a:b] = (gy @ w_out.T) / env.count[a:b].clamp_min(1.0)[:, None, None]
            dkv = torch.zeros_like(kv)
            for a, b in _spans(sh.receivers_local.shape[0], s, d):  # the attention's backward
                recv, m = sh.receivers_local[a:b], sh.edge_mask[a:b]
                with torch.enable_grad():
                    x, leaf = _lean_input(h, x_norm, table, env, recv, grad=True)
                    w, bias = (t.detach().requires_grad_() for t in (w_qkv, b_qkv))
                    kve = kv[env.halo.senders_ext[a:b]].requires_grad_()
                    msg, _ = attention_core(x @ w[:, :d] + bias[:d], kve[..., :d], kve[..., d:],
                                            env.num_heads, softmax=env.softmax)
                    gm = torch.where(m[:, None, None], dsum[recv], dsum.new_zeros(()))
                    gx, gw, gb, gkv = torch.autograd.grad(msg, [leaf, w, bias, kve], gm)
                push(gx, recv)
                dw_qkv += gw
                db_qkv += gb
                segment_sum_into(dkv, gkv, env.halo.senders_ext[a:b])
            del kv, dsum
            offsets, sizes = env.halo.meta
            if offsets:  # the halo rows' gradients back to their owners
                back = ring_exchange_rows(dkv[n_loc:], env.mesh, offsets, sizes, env.axis,
                                          reverse=True)
                segment_sum_into(dkv[:n_loc], back, env.halo.send_idx[: sum(sizes)])
            for a, b in _spans(n_loc, s, d):  # the K|V projection's backward
                with torch.enable_grad():
                    x, leaf = _lean_input(h, x_norm, table, env, slice(a, b), grad=True)
                    w, bias = (t.detach().requires_grad_() for t in (w_qkv, b_qkv))
                    gx, gw, gb = torch.autograd.grad(x @ w[:, d:] + bias[d:], [leaf, w, bias],
                                                     dkv[a:b])
                push(gx, slice(a, b))
                dw_qkv += gw
                db_qkv += gb
        return (*grads[:4], dh, None, dtable, None)


def _sharded_gcn_conv(x_local, gcn, shard: Shard, mesh: Mesh, axis: str = "graph",
                      halo: Optional[LocalHalo] = None) -> torch.Tensor:
    """One Kipf-Welling GCN hop (``gcn``: a GCNConv) on a receiver-owned
    edge partition: transform locally (F -> D before the exchange),
    exchange the transformed rows and 1/sqrt(degree), weighted segment sum
    with the self-loop of every local row."""
    n_loc = x_local.shape[0]
    h_local = gcn.lin(x_local)
    deg_local = segment_count(shard.receivers_local, n_loc, shard.edge_mask) + 1.0
    dinv_local = 1.0 / torch.sqrt(deg_local)
    if halo is not None:
        h_all = halo_exchange(h_local, halo.send_idx, halo.meta, mesh, axis)
        dinv_all = halo_exchange(dinv_local, halo.send_idx, halo.meta, mesh, axis)
        senders_ref = halo.senders_ext
    else:
        h_all = all_gather_rows(h_local, mesh, axis)
        dinv_all = all_gather_rows(dinv_local, mesh, axis)
        senders_ref = shard.senders_global
    w = dinv_all[senders_ref] * dinv_local[shard.receivers_local]
    msgs = h_all[senders_ref] * w[:, None]
    agg = segment_sum(msgs, shard.receivers_local, n_loc, shard.edge_mask)
    agg = agg + h_local * (dinv_local ** 2)[:, None]
    return agg + gcn.bias


def _convs(model, tokens, shard: Shard, mesh: Mesh, axis: str, layout, tile_nodes: int,
           halo, remat: bool) -> torch.Tensor:
    """The two convs, relu each, then the mean over tokens: [N_loc, D]."""
    cfg = model.config

    def conv(tokens_in, layer):
        return _sharded_amp_conv(tokens_in, shard, layer, cfg.num_heads, cfg.attn_softmax, mesh,
                                 axis, layout=layout, tile_nodes=tile_nodes, halo=halo)

    def run(tokens_in, layer):
        if remat:
            return torch.utils.checkpoint.checkpoint(conv, tokens_in, layer,
                                                     use_reentrant=False)
        return conv(tokens_in, layer)

    h = torch.relu(run(tokens, model.conv1))
    h = torch.relu(run(h, model.conv2))
    return h.mean(dim=1)


def amp_gcn_forward_local(
    model,
    shard: Shard,
    mesh: Mesh,
    axis: str = "graph",
    layout: Optional[LocalLayout] = None,
    tile_nodes: int = DEFAULT_TILE_NODES,
    scaler_stats=None,
    halo: Optional[LocalHalo] = None,
    remat: bool = False,
    generator: Optional[torch.Generator] = None,
    sampled_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-shard AMPGCN forward (deterministic: no dropout) with
    boundary-exchanged convs, the model's (an AMPGCN's) parameters. The
    config's scaler ('precomputed': ``scaler_stats`` or the model's own
    stats; otherwise global batch statistics summed over ``axis``) and
    token sampling ('tfidf' with document frequencies and the real node
    count summed over ``axis``) as the JAX package's. ``sampled_idx``
    [N_loc, S] injects the draw, else it comes from ``generator``.
    ``remat`` recomputes each conv in the backward
    (``torch.utils.checkpoint``; its exchange then runs again, in the same
    order on every rank); on the plain path with the halo exchange, through
    ``_LeanHaloConv``, which keeps across the step no more than conv2's
    input and rebuilds conv1's tokens from the draw."""
    cfg = model.config
    x = shard.x
    if cfg.scaler == "precomputed":
        if scaler_stats is None:
            scaler_stats = (model.scaler_mean, model.scaler_std)
        if scaler_stats[0] is None:
            raise ValueError(
                "cfg.scaler='precomputed' requires scaler_stats — a silent "
                "batch-stats fallback would diverge from the checkpoint's "
                "training normalization")
        mean, std = (torch.as_tensor(np.asarray(_np(a)), dtype=x.dtype, device=x.device)
                     for a in scaler_stats)
    else:
        w = shard.node_mask.to(x.dtype)[:, None]
        n_glob = all_reduce(w.sum(), mesh, axis)
        mean = all_reduce((x * w).sum(0), mesh, axis) / n_glob.clamp_min(1.0)
        var = all_reduce((w * (x - mean) ** 2).sum(0), mesh, axis) / n_glob.clamp_min(1.0)
        std = torch.sqrt(var)
    x_norm = (x - mean) / torch.where(std == 0.0, torch.ones_like(std), std)

    if sampled_idx is None:
        if cfg.token_sampling == "tfidf":
            df = all_reduce((x != 0).sum(0).to(torch.float32), mesh, axis)
            n_rows = all_reduce(shard.node_mask.to(torch.float32).sum(), mesh, axis)
            sampled_idx = tfidf_sample_features(x, cfg.num_sampled_vectors, generator=generator,
                                                doc_freq=df, num_rows=n_rows)
        else:
            sampled_idx = sample_present_features(x, cfg.num_sampled_vectors, generator=generator)
    if remat and layout is None and halo is not None:
        count = segment_count(shard.receivers_local, x.shape[0], shard.edge_mask)

        def lean(layer, pool, h=None, idx=None):
            env = _LeanEnv(shard, halo, mesh, axis, cfg.num_heads, cfg.attn_softmax, pool, idx,
                           count)
            return _LeanHaloConv.apply(layer.w_qkv, layer.b_qkv, layer.w_out, layer.b_out, h,
                                       None if h is not None else x_norm,
                                       None if h is not None else model.tokenizer.table(), env)

        pooled = lean(model.conv2, True, h=lean(model.conv1, False, idx=sampled_idx.long()))
    else:
        pooled = _convs(model, gather_tokens(x_norm, sampled_idx, model.tokenizer.table()),
                        shard, mesh, axis, layout, tile_nodes, halo, remat)

    if model.raw_mode:
        if model.raw_mode == "mlp":
            xr = torch.relu(model.raw_residual_proj(x_norm))
        else:
            xr = torch.relu(_sharded_gcn_conv(x_norm, model.raw_residual_conv1, shard, mesh,
                                              axis, halo=halo))
            if model.raw_mode == "gcn2":
                xr = torch.relu(_sharded_gcn_conv(xr, model.raw_residual_conv2, shard, mesh,
                                                  axis, halo=halo))
        pooled = torch.cat([pooled, xr], dim=-1)
    return torch.log_softmax(model.final_linear_out(pooled), dim=-1)


def _loss_share(nll, node_norm, m, loss_mode: str, mesh: Mesh, axis: str = "graph"):
    """This rank's share of the replica loss reduced over ``axis`` (the
    modes of train/losses.py): its nodes' part of the sum over the global
    denominator, so that the shares of the ranks add up to the loss."""
    if loss_mode == "saint":
        return (nll * node_norm * m).sum()
    if loss_mode == "saint_mean":
        ws = all_reduce((node_norm * m).sum(), mesh, axis)
        return (nll * node_norm * m).sum() / ws.clamp_min(1e-12)
    if loss_mode == "full":
        count = all_reduce(m.sum(), mesh, axis)
        return (nll * m).sum() / count.clamp_min(1.0)
    raise ValueError(f"unknown loss_mode {loss_mode!r}")


def rank_generator(seed: int, mesh: Mesh) -> torch.Generator:
    """A generator of its own for each rank, seeded from (seed, data
    index, graph index): the JAX package folds the step key per shard."""
    s = np.random.SeedSequence([seed, mesh.index("data"), mesh.index("graph")])
    return torch.Generator(device=mesh.device).manual_seed(int(s.generate_state(1)[0]))


def _local(obj, index: Tuple[int, ...], device):
    """A host-side stacked object's slice for this rank; a local one as it is."""
    return obj.local(index, device) if hasattr(obj, "local") else obj


def _make_step(model, mesh: Mesh, loss_mode: str, data_axis: bool, use_pallas: bool,
               tile_nodes: int, scaler_stats, use_halo: bool, remat: bool):
    params = list(model.parameters())

    def step(state, pg, *extra, sampled_idx=None):
        if state.model is not model:
            raise ValueError("the state belongs to another model than this step")
        index = ((mesh.index("data"),) if data_axis else ()) + (mesh.index("graph"),)
        rest = list(extra)
        layout = _local(rest.pop(0), index, mesh.device) if use_pallas else None
        halo = _local(rest.pop(0), index, mesh.device) if use_halo else None
        if rest:
            raise ValueError(f"{len(rest)} arguments beyond the layout and the halo plan")
        shard = _local(pg, index, mesh.device)
        if sampled_idx is not None and not isinstance(sampled_idx, torch.Tensor):
            sampled_idx = _pick(np.asarray(sampled_idx), index, mesh.device, torch.int64)
        state.optimizer.zero_grad()
        logp = amp_gcn_forward_local(model, shard, mesh, layout=layout, tile_nodes=tile_nodes,
                                     scaler_stats=scaler_stats, halo=halo, remat=remat,
                                     generator=state.generator, sampled_idx=sampled_idx)
        m = (shard.train_mask & shard.node_mask).to(logp.dtype)
        nll = -torch.gather(logp, 1, shard.y[:, None])[:, 0]
        share = _loss_share(nll, shard.node_norm, m, loss_mode, mesh) / mesh.size("data")
        share.backward()
        all_reduce_grads(params, mesh, ("data", "graph"))
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            loss = all_reduce(share.detach(), mesh, ("data", "graph"))
            correct = ((logp.argmax(-1) == shard.y).to(torch.float32) * m).sum()
            tallies = all_reduce(torch.stack([correct, m.sum()]), mesh, ("data", "graph"))
        return state, {"loss": loss, "train_acc": tallies[0] / tallies[1].clamp_min(1.0)}

    return step


def make_partitioned_train_step(model, mesh: Mesh, loss_mode: str = "full",
                                use_pallas: bool = False,
                                tile_nodes: int = DEFAULT_TILE_NODES, scaler_stats=None,
                                use_halo: bool = False, remat: bool = False):
    """step(state, pg, [layouts], [halo], sampled_idx=None) -> (state,
    metrics): one optimizer step of the edge-partitioned model over the
    'graph' axis. ``pg``, the layouts (``partition_layouts``, with
    ``use_pallas``: the convs through the fused kernels) and the halo plan
    (``build_halo_plan``, with ``use_halo``: the boundary-only exchange;
    the layouts then built with it) are the host-side stacks [P, ...] (the
    rank takes its slice) or the rank's own ``.local`` slices. The state's
    generator should be the rank's (``rank_generator``)."""
    return _make_step(model, mesh, loss_mode, False, use_pallas, tile_nodes, scaler_stats,
                      use_halo, remat)


def make_dp_partitioned_train_step(model, mesh: Mesh, loss_mode: str = "saint",
                                   use_pallas: bool = False,
                                   tile_nodes: int = DEFAULT_TILE_NODES, scaler_stats=None,
                                   use_halo: bool = False, remat: bool = False):
    """The data-parallel x graph-partitioned step: the stacks carry two
    leading axes [data, graph]; each data replica trains on its own
    subgraph, edge-partitioned over 'graph'. The replica losses are summed
    over 'graph' and averaged over 'data'; the gradients summed over both
    (each rank's share carries the 1/data). Per-replica halo plans share one
    structure (``common_halo_meta``, ``stack_halos``)."""
    return _make_step(model, mesh, loss_mode, True, use_pallas, tile_nodes, scaler_stats,
                      use_halo, remat)


def stack_partitioned(pgs: Sequence[PartitionedGraph]) -> PartitionedGraph:
    """Stack per-replica PartitionedGraphs into [data, graph, ...] leaves."""
    return PartitionedGraph(*(np.stack(leaves) for leaves in zip(*pgs)))


def stack_layouts(layouts: Sequence[ShardLayout]) -> ShardLayout:
    """Stack per-replica ShardLayouts into [data, graph, ...] leaves (a
    common edges_per_tile in partition_layouts, so that they stack)."""
    return ShardLayout(*(np.stack(leaves) for leaves in zip(*layouts)))


def stack_halos(plans: Sequence[HaloPlan]) -> HaloPlan:
    """Stack per-replica HaloPlans into [data, graph, ...] leaves. All must
    share one offset structure (``build_halo_plan(pg,
    force_meta=common_halo_meta(pgs))``)."""
    metas = {pl.meta for pl in plans}
    if len(metas) != 1:
        raise ValueError(
            f"stack_halos: replicas have different halo metas {sorted(metas)}"
            " — rebuild each plan with build_halo_plan(pg, force_meta=...)"
            " (see common_halo_meta) so the ext index spaces agree")
    return HaloPlan(np.stack([pl.send_idx for pl in plans]),
                    np.stack([pl.senders_ext for pl in plans]),
                    np.stack([pl.pair_counts for pl in plans]), *plans[0].meta)


def common_halo_meta(pgs: Sequence[PartitionedGraph], pad_to: int = 8):
    """(offsets, sizes) covering every replica's needs: the force_meta that
    makes per-replica plans stackable."""
    need = {}
    for pg in pgs:
        p_shards = pg.num_shards
        n_loc = pg.x.shape[1]
        sg = np.asarray(pg.senders_global)
        em = np.asarray(pg.edge_mask)
        for q in range(p_shards):
            s_q = sg[q][em[q]]
            owners = s_q // n_loc
            for p in range(p_shards):
                if p == q:
                    continue
                k = len(np.unique(s_q[owners == p]))
                o = (q - p) % p_shards
                need[o] = max(need.get(o, 0), k)
    offsets = tuple(sorted(o for o in need if need[o] > 0))
    sizes = tuple(-(-need[o] // pad_to) * pad_to for o in offsets)
    return offsets, sizes
