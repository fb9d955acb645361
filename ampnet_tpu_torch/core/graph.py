"""Padded, fixed-size graph container of torch tensors.

Mirrors ``ampnet_tpu/core/graph.py``: every graph is padded to a
(num_nodes, num_edges) bucket with validity masks; padded edges point at
node 0 and are masked out of every aggregation.

Edge convention (PyG flow='source_to_target'):
  senders[e]   = source node  (x_j in the reference's message())
  receivers[e] = destination node (x_i; messages are aggregated per receiver)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass
class Graph:
    """A padded, fixed-shape graph. N = padded nodes, E = padded edges."""

    x: torch.Tensor            # [N, F] float32
    senders: torch.Tensor      # [E] int64
    receivers: torch.Tensor    # [E] int64
    node_mask: torch.Tensor    # [N] bool
    edge_mask: torch.Tensor    # [E] bool
    y: Optional[torch.Tensor] = None            # [N] int64
    train_mask: Optional[torch.Tensor] = None   # [N] bool
    val_mask: Optional[torch.Tensor] = None
    test_mask: Optional[torch.Tensor] = None
    node_norm: Optional[torch.Tensor] = None    # [N] float32
    edge_norm: Optional[torch.Tensor] = None    # [E] float32

    @property
    def num_nodes_padded(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges_padded(self) -> int:
        return self.senders.shape[0]

    @property
    def num_nodes(self) -> int:
        return int(self.node_mask.sum())

    @property
    def num_edges(self) -> int:
        return int(self.edge_mask.sum())

    def to(self, device) -> "Graph":
        return Graph(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)
        })


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _t(a: Optional[np.ndarray], dtype) -> Optional[torch.Tensor]:
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def from_arrays(
    x: np.ndarray,
    edge_index: np.ndarray,
    y: Optional[np.ndarray] = None,
    train_mask: Optional[np.ndarray] = None,
    val_mask: Optional[np.ndarray] = None,
    test_mask: Optional[np.ndarray] = None,
    node_norm: Optional[np.ndarray] = None,
    edge_norm: Optional[np.ndarray] = None,
    pad_nodes_to: Optional[int] = None,
    pad_edges_to: Optional[int] = None,
    node_multiple: int = 8,
    edge_multiple: int = 128,
) -> Graph:
    """Build a padded Graph (CPU tensors) from host arrays.

    edge_index is the reference's [2, E] int array: row 0 = senders (x_j),
    row 1 = receivers (x_i). Move the result with ``Graph.to(device)``.
    """
    x = np.asarray(x, dtype=np.float32)
    edge_index = np.asarray(edge_index, dtype=np.int32)
    n, e = x.shape[0], edge_index.shape[1]
    n_pad = pad_nodes_to if pad_nodes_to is not None else _round_up(max(n, 1), node_multiple)
    e_pad = pad_edges_to if pad_edges_to is not None else _round_up(max(e, 1), edge_multiple)
    if n_pad < n or e_pad < e:
        raise ValueError(f"pad sizes ({n_pad},{e_pad}) smaller than graph ({n},{e})")
    if e > 0:
        lo, hi = int(edge_index.min()), int(edge_index.max())
        if lo < 0 or hi >= n:
            raise ValueError(
                f"edge_index references node ids [{lo}, {hi}] outside [0, {n})")

    def pad_n(a, fill, dtype):
        if a is None:
            return None
        a = np.asarray(a, dtype=dtype)
        out = np.full((n_pad,) + a.shape[1:], fill, dtype=dtype)
        out[:n] = a
        return out

    xp = np.zeros((n_pad, x.shape[1]), dtype=np.float32)
    xp[:n] = x
    senders = np.zeros((e_pad,), dtype=np.int64)
    receivers = np.zeros((e_pad,), dtype=np.int64)
    senders[:e] = edge_index[0]
    receivers[:e] = edge_index[1]
    node_mask = np.zeros((n_pad,), dtype=bool)
    node_mask[:n] = True
    edge_mask = np.zeros((e_pad,), dtype=bool)
    edge_mask[:e] = True

    return Graph(
        x=_t(xp, torch.float32),
        senders=_t(senders, torch.int64),
        receivers=_t(receivers, torch.int64),
        node_mask=_t(node_mask, torch.bool),
        edge_mask=_t(edge_mask, torch.bool),
        y=_t(pad_n(y, 0, np.int64), torch.int64),
        train_mask=_t(pad_n(train_mask, False, bool), torch.bool),
        val_mask=_t(pad_n(val_mask, False, bool), torch.bool),
        test_mask=_t(pad_n(test_mask, False, bool), torch.bool),
        node_norm=_t(pad_n(node_norm, 0.0, np.float32), torch.float32),
        edge_norm=None if edge_norm is None else _t(
            _pad_checked_edges(np.asarray(edge_norm, np.float32), e, e_pad),
            torch.float32),
    )


def _pad_checked_edges(a: np.ndarray, e: int, e_pad: int) -> np.ndarray:
    """Pad a per-edge array to e_pad with zeros, validating its length
    against the LIVE edge count (an already-padded or short array would
    silently build a wrong-length field and fail far from the cause)."""
    if a.shape[0] != e:
        raise ValueError(
            f"per-edge array has length {a.shape[0]}, expected the live "
            f"edge count {e} (pass UNPADDED per-edge data)")
    out = np.zeros((e_pad,) + a.shape[1:], a.dtype)
    out[:e] = a
    return out


def build_csr(edge_index: np.ndarray, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side CSR (indptr, indices) over SENDERS, for random walks."""
    senders = np.asarray(edge_index[0])
    receivers = np.asarray(edge_index[1])
    order = np.argsort(senders, kind="stable")
    indices = receivers[order].astype(np.int32)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(senders[order], minlength=num_nodes))
    return indptr, indices


def pad_graph(g: Graph, n_pad: int, e_pad: int) -> Graph:
    """Re-pad an existing Graph to LARGER static sizes."""
    if n_pad < g.num_nodes_padded or e_pad < g.num_edges_padded:
        raise ValueError(
            f"pad_graph target ({n_pad},{e_pad}) smaller than current "
            f"({g.num_nodes_padded},{g.num_edges_padded}) — shrinking "
            f"requires rebuilding via from_arrays")

    def pad(a, size, fill):
        if a is None:
            return None
        out = torch.full((size,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                         device=a.device)
        out[: a.shape[0]] = a
        return out

    return Graph(
        x=pad(g.x, n_pad, 0.0),
        senders=pad(g.senders, e_pad, 0),
        receivers=pad(g.receivers, e_pad, 0),
        node_mask=pad(g.node_mask, n_pad, False),
        edge_mask=pad(g.edge_mask, e_pad, False),
        y=pad(g.y, n_pad, 0),
        train_mask=pad(g.train_mask, n_pad, False),
        val_mask=pad(g.val_mask, n_pad, False),
        test_mask=pad(g.test_mask, n_pad, False),
        node_norm=pad(g.node_norm, n_pad, 0.0),
        edge_norm=pad(g.edge_norm, e_pad, 0.0),
    )


def sort_edges_by_receiver(g: Graph) -> Tuple[Graph, torch.Tensor]:
    """Sort edges so receivers are contiguous (sorted-CSR order). Returns
    the sorted graph and the permutation (for unsorting aux data). Padded
    edges (mask False) sort to the end, in their order."""
    key = torch.where(g.edge_mask, g.receivers, torch.full_like(g.receivers, 2**30))
    perm = torch.sort(key, stable=True).indices
    return dataclasses.replace(
        g, senders=g.senders[perm], receivers=g.receivers[perm],
        edge_mask=g.edge_mask[perm],
        edge_norm=None if g.edge_norm is None else g.edge_norm[perm]), perm


def add_self_loops(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Append (i, i) for every node."""
    loops = np.arange(num_nodes, dtype=edge_index.dtype)
    return np.concatenate([edge_index, np.stack([loops, loops])], axis=1)
