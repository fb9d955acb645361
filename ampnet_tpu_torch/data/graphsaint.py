"""GraphSAINT random-walk subgraph sampler (``ampnet_tpu/data/graphsaint.py``
for the port): a host-side numpy sampler that emits STATIC-SHAPE padded
``Graph``s, so every training step sees the same tensor shapes.

  1. sample ``batch_size`` uniform start nodes, run random walks of
     ``walk_length`` steps over the CSR adjacency;
  2. unique node set -> induced subgraph with remapped edge indices;
  3. normalization pre-pass: sample subgraphs until N * sample_coverage
     nodes were seen; node_norm = num_samples / node_count / N,
     edge_norm = clamp(node_count[src] / edge_count, 0, 1e4);
  4. pad to (pad_nodes_to, pad_edges_to) with validity masks.

Walks are pointer chasing and stay on the host; ``prefetch`` samples in a
background thread so that they overlap the device's work. The graphs are
CPU tensors: the training loop moves each to the model's device.

With the same seed this sampler draws the same random numbers in the same
order as the JAX package's numpy path (``use_native=False``) and yields
array-equal subgraphs. The JAX package's native (C++) sampling core is not
ported yet, so there is no ``use_native`` switch here.
"""
from __future__ import annotations

import queue
import threading
import warnings
from typing import Iterator, Optional, Tuple

import numpy as np

from ampnet_tpu_torch.core.graph import Graph, build_csr, from_arrays


def random_walk(
    indptr: np.ndarray,
    indices: np.ndarray,
    starts: np.ndarray,
    walk_length: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Uniform random walks over CSR adjacency: at each step a uniform
    random out-neighbor; nodes without out-edges stay put. Returns
    [num_walks, walk_length + 1] node ids."""
    num_walks = len(starts)
    walks = np.empty((num_walks, walk_length + 1), dtype=np.int64)
    walks[:, 0] = starts
    cur = starts.astype(np.int64)
    if len(indices) == 0:  # edgeless graph: every walker stays put
        walks[:, 1:] = cur[:, None]
        return walks
    for step in range(walk_length):
        deg = indptr[cur + 1] - indptr[cur]
        r = rng.random(num_walks)
        offset = np.floor(r * np.maximum(deg, 1)).astype(np.int64)
        nxt = np.where(deg > 0, indices[np.minimum(indptr[cur] + offset, len(indices) - 1)], cur)
        walks[:, step + 1] = nxt
        cur = nxt
    return walks


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class GraphSaintRandomWalkSampler:
    """Iterable sampler yielding padded induced subgraphs of a base graph.

    batch_size = walk roots, walk_length, num_steps = subgraphs per epoch,
    sample_coverage = the normalization pre-pass (0 disables it). Pad sizes
    default to a generous bound from a 20-draw dry run."""

    def __init__(
        self,
        x: np.ndarray,
        edge_index: np.ndarray,
        y: Optional[np.ndarray] = None,
        train_mask: Optional[np.ndarray] = None,
        val_mask: Optional[np.ndarray] = None,
        test_mask: Optional[np.ndarray] = None,
        batch_size: int = 8,
        walk_length: int = 150,
        num_steps: int = 200,
        sample_coverage: int = 100,
        pad_nodes_to: Optional[int] = None,
        pad_edges_to: Optional[int] = None,
        seed: int = 0,
    ):
        self.x = np.asarray(x, dtype=np.float32)
        self.edge_index = np.asarray(edge_index, dtype=np.int64)
        self.y = None if y is None else np.asarray(y)
        self.train_mask = train_mask
        self.val_mask = val_mask
        self.test_mask = test_mask
        self.batch_size = batch_size
        self.walk_length = walk_length
        self.num_steps = num_steps
        self.sample_coverage = sample_coverage
        self.rng = np.random.default_rng(seed)

        self.N = self.x.shape[0]
        self.E = self.edge_index.shape[1]
        self.indptr, self.indices = build_csr(self.edge_index, self.N)
        # for induced subgraphs we need the original edge ids: sort edges by
        # (src, dst) so that a node's out-edges are one slice
        order = np.lexsort((self.edge_index[1], self.edge_index[0]))
        self._edge_order = order
        self._src_sorted = self.edge_index[0][order]
        self._dst_sorted = self.edge_index[1][order]
        self._src_indptr = np.zeros(self.N + 1, dtype=np.int64)
        self._src_indptr[1:] = np.cumsum(np.bincount(self._src_sorted, minlength=self.N))
        # relabel scratch of _collate: only the touched entries are reset
        self._relabel = np.full(self.N, -1, np.int64)

        if sample_coverage > 0:
            self.node_norm, self.edge_norm = self._compute_norm()
        else:
            self.node_norm = np.ones(self.N, dtype=np.float32)
            self.edge_norm = np.ones(self.E, dtype=np.float32)

        if pad_nodes_to is None or pad_edges_to is None:
            max_n, max_e = 0, 0
            probe_rng = np.random.default_rng(seed + 12345)
            for _ in range(20):
                nodes, eids = self._subgraph(probe_rng)
                max_n, max_e = max(max_n, len(nodes)), max(max_e, len(eids))
            pad_nodes_to = pad_nodes_to or _round_up(int(max_n * 1.3) + 8, 64)
            pad_edges_to = pad_edges_to or _round_up(int(max_e * 1.3) + 8, 128)
        self.pad_nodes_to = pad_nodes_to
        self.pad_edges_to = pad_edges_to

    # -- sampling core ------------------------------------------------------
    def _sample_nodes(self, rng: np.random.Generator) -> np.ndarray:
        starts = rng.integers(0, self.N, size=self.batch_size)
        walks = random_walk(self.indptr, self.indices, starts, self.walk_length, rng)
        return np.unique(walks)

    def _induced_edge_ids(self, nodes: np.ndarray) -> np.ndarray:
        """Original edge ids whose endpoints are both in ``nodes`` (a sorted
        set): candidates by source membership (each node's span start
        repeated, plus a per-span ramp from one cumsum), kept by destination
        membership."""
        in_set = np.zeros(self.N, dtype=bool)
        in_set[nodes] = True
        starts_ = self._src_indptr[nodes]
        counts = self._src_indptr[nodes + 1] - starts_
        total = int(counts.sum())
        if total == 0:
            return self._edge_order[np.empty(0, dtype=np.int64)]
        ramp = np.arange(total, dtype=np.int64)
        ramp -= np.repeat(np.cumsum(counts) - counts, counts)
        cand = np.repeat(starts_, counts) + ramp
        keep = in_set[self._dst_sorted[cand]]
        return self._edge_order[cand[keep]]

    def _subgraph(self, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        nodes = self._sample_nodes(rng)
        return nodes, self._induced_edge_ids(nodes)

    # -- normalization pre-pass ---------------------------------------------
    def _compute_norm(self) -> Tuple[np.ndarray, np.ndarray]:
        norm_rng = np.random.default_rng(int(self.rng.integers(2**63)))
        node_count = np.zeros(self.N, dtype=np.float64)
        edge_count = np.zeros(self.E, dtype=np.float64)
        num_samples = total_sampled = 0
        while total_sampled < self.N * self.sample_coverage:
            for _ in range(self.num_steps):
                nodes, eids = self._subgraph(norm_rng)
                node_count[nodes] += 1
                edge_count[eids] += 1
                total_sampled += len(nodes)
            num_samples += self.num_steps
        return self._finish_norm(node_count, edge_count, num_samples)

    def _finish_norm(
        self, node_count: np.ndarray, edge_count: np.ndarray, num_samples: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        src = self.edge_index[0]
        with np.errstate(divide="ignore", invalid="ignore"):
            edge_norm = node_count[src] / edge_count
        edge_norm = np.clip(edge_norm, 0, 1e4)
        edge_norm[~np.isfinite(edge_norm)] = 0.1
        node_count = node_count.copy()
        node_count[node_count == 0] = 0.1
        node_norm = num_samples / node_count / self.N
        return node_norm.astype(np.float32), edge_norm.astype(np.float32)

    # -- collate ------------------------------------------------------------
    def _collate(self, nodes: np.ndarray, eids: np.ndarray) -> Graph:
        relabel = self._relabel
        relabel[nodes] = np.arange(len(nodes))
        sub_edges = relabel[self.edge_index[:, eids]]
        relabel[nodes] = -1

        def sel(a):
            return None if a is None else np.asarray(a)[nodes]

        return from_arrays(
            self.x[nodes],
            sub_edges,
            y=sel(self.y),
            train_mask=sel(self.train_mask),
            val_mask=sel(self.val_mask),
            test_mask=sel(self.test_mask),
            node_norm=self.node_norm[nodes],
            edge_norm=self.edge_norm[eids],
            pad_nodes_to=self.pad_nodes_to,
            pad_edges_to=self.pad_edges_to,
        )

    def sample(self) -> Graph:
        nodes, eids = self._subgraph(self.rng)
        # A tail-large subgraph can exceed the pad sizes the 20-draw probe
        # estimated: regrow to the next bucket (new tensor shapes from here
        # on) rather than kill a long run.
        if len(nodes) > self.pad_nodes_to or len(eids) > self.pad_edges_to:
            new_n = max(self.pad_nodes_to, _round_up(int(len(nodes) * 1.3) + 8, 64))
            new_e = max(self.pad_edges_to, _round_up(int(len(eids) * 1.3) + 8, 128))
            warnings.warn(
                f"GraphSAINT subgraph ({len(nodes)} nodes, {len(eids)} edges) "
                f"exceeds pad budget ({self.pad_nodes_to}, {self.pad_edges_to}); "
                f"regrowing to ({new_n}, {new_e})",
                stacklevel=2,
            )
            self.pad_nodes_to, self.pad_edges_to = new_n, new_e
        return self._collate(nodes, eids)

    def __len__(self) -> int:
        return self.num_steps

    def __iter__(self) -> Iterator[Graph]:
        for _ in range(self.num_steps):
            yield self.sample()

    def prefetch(self, depth: int = 4) -> Iterator[Graph]:
        """Iterate one epoch with a background producer thread, so that host
        sampling overlaps device compute. Yields the sequence ``__iter__``
        would."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up when the consumer is gone: an
            # unconditional put against a full queue would leave the thread
            # blocked forever when a loop abandons the generator mid-epoch
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # an exception must reach the consumer: a dead producer with no
            # sentinel would leave the training loop blocked on q.get()
            try:
                for g in self:
                    if not put(g):
                        return
                put(None)
            except BaseException as e:  # noqa: BLE001 (re-raised consumer-side)
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # GeneratorExit (abandoned consumer) or normal end: release the
            # producer, drain whatever it already queued, and wait for it, so
            # that the next epoch's producer never shares the generator
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10.0)
