"""Plain-NumPy reference of the GraphSAINT random-walk sampler, written from
its specification so that the subgraphs a training run saw can be drawn
again from the sampler's seed:

* the sampler's own stream is NumPy's ``default_rng(seed)``; the
  normalization pre-pass takes its seed first (``integers(2**63)``);
* a subgraph: ``batch`` start nodes (``integers(0, N, size=batch)``), a
  walk seed (``integers(2**63)``), then uniform walks of ``walk_length``
  steps over the senders' CSR on one std::mt19937_64 stream: at each step
  the next node is ``indices[lo + out % (hi - lo)]``, and a node without
  out-edges stays put and draws nothing; the nodes are the walks' sorted
  unique ids, the edges every edge with both ends among them, in the order
  of the (sender, receiver)-sorted edge list;
* the pre-pass: subgraph k (k = 0, 1, ...) draws from a stream of its own
  seeded with seed + 0x9e3779b97f4a7c15 * (k + 1) (mod 2**64): the starts
  as ``out % N``, then the walk seed; samples are counted in chunks of
  ``threads * 4`` until N * coverage nodes were seen; node_norm =
  samples / count / N, a node never seen counting 0.1;
* pad sizes: 20 subgraphs from ``default_rng(seed + 12345)``, the largest
  node and edge counts times 1.3 plus 8, rounded up to 64 and 128; a
  subgraph beyond them grows them by the same rule."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

N64 = 312
M64 = 156
MATRIX_A = np.uint64(0xB5026F5AA96619E9)
UPPER = np.uint64(0xFFFFFFFF80000000)
LOWER = np.uint64(0x7FFFFFFF)
MASK64 = (1 << 64) - 1
GOLDEN = 0x9E3779B97F4A7C15
PREPASS_THREADS = 8
PREPASS_PER_THREAD = 4


class MT19937_64:
    """std::mt19937_64, 312 outputs at a time."""

    def __init__(self, seed: int):
        mt = [seed & MASK64]
        for i in range(1, N64):
            prev = mt[-1]
            mt.append((6364136223846793005 * (prev ^ (prev >> 62)) + i) & MASK64)
        self.mt = np.array(mt, dtype=np.uint64)
        self.out = np.empty(0, np.uint64)
        self.at = N64

    def _twist(self) -> None:
        mt, new = self.mt, self.mt.copy()
        one = np.uint64(1)

        def mix(hi, lo):
            x = (hi & UPPER) | (lo & LOWER)
            return (x >> one) ^ ((x & one) * MATRIX_A)

        i = np.arange(0, N64 - M64)
        new[i] = mt[i + M64] ^ mix(mt[i], mt[i + 1])
        i = np.arange(N64 - M64, N64 - 1)
        new[i] = new[i + M64 - N64] ^ mix(mt[i], mt[i + 1])
        new[N64 - 1] = new[M64 - 1] ^ mix(mt[N64 - 1], new[0])
        self.mt = new
        y = new.copy()
        y ^= (y >> np.uint64(29)) & np.uint64(0x5555555555555555)
        y ^= (y << np.uint64(17)) & np.uint64(0x71D67FFFEDA60000)
        y ^= (y << np.uint64(37)) & np.uint64(0xFFF7EEE000000000)
        y ^= y >> np.uint64(43)
        self.out, self.at = y, 0

    def __call__(self) -> int:
        if self.at == N64:
            self._twist()
        v = int(self.out[self.at])
        self.at += 1
        return v


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Sampler:
    """The sampler's draws over a base graph's ``edge_index`` [2, E]."""

    def __init__(self, edge_index: np.ndarray, num_nodes: int, batch: int, walk_length: int,
                 coverage: int, seed: int):
        src, dst = (np.asarray(a, np.int64) for a in edge_index)
        self.n, self.batch, self.walk_length = num_nodes, batch, walk_length
        order = np.argsort(src, kind="stable")
        self.indices = dst[order]
        self.indptr = np.zeros(num_nodes + 1, np.int64)
        self.indptr[1:] = np.cumsum(np.bincount(src, minlength=num_nodes))
        self.sorted_ids = np.lexsort((dst, src))
        self.sorted_src, self.sorted_dst = src[self.sorted_ids], dst[self.sorted_ids]
        self.rng = np.random.default_rng(seed)
        self.node_norm = self._prepass(int(self.rng.integers(2**63)), coverage)
        probe = np.random.default_rng(seed + 12345)
        sizes = [tuple(map(len, self._subgraph(probe))) for _ in range(20)]
        self.pad_nodes = _round_up(int(max(n for n, _ in sizes) * 1.3) + 8, 64)
        self.pad_edges = _round_up(int(max(e for _, e in sizes) * 1.3) + 8, 128)

    def _walk(self, starts: np.ndarray, seed: int) -> np.ndarray:
        rng = MT19937_64(seed)
        walks = np.empty((len(starts), self.walk_length + 1), np.int64)
        indptr, indices = self.indptr, self.indices
        for w, cur in enumerate(starts):
            cur = int(cur)
            walks[w, 0] = cur
            for t in range(1, self.walk_length + 1):
                lo, hi = int(indptr[cur]), int(indptr[cur + 1])
                if hi > lo:
                    cur = int(indices[lo + rng() % (hi - lo)])
                walks[w, t] = cur
        return walks

    def induced(self, nodes: np.ndarray) -> np.ndarray:
        """Edge ids with both ends in ``nodes``, in (sender, receiver) order."""
        inside = np.zeros(self.n, bool)
        inside[nodes] = True
        keep = inside[self.sorted_src] & inside[self.sorted_dst]
        return self.sorted_ids[keep]

    def _subgraph(self, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        starts = rng.integers(0, self.n, size=self.batch)
        nodes = np.unique(self._walk(starts, int(rng.integers(2**63))))
        return nodes, self.induced(nodes)

    def _prepass(self, seed: int, coverage: int) -> np.ndarray:
        count = np.zeros(self.n, np.float64)
        target, seen, samples, chunk = self.n * coverage, 0, 0, 0
        per_chunk = PREPASS_THREADS * PREPASS_PER_THREAD
        while seen < target:
            for j in range(per_chunk):
                k = chunk * per_chunk + j
                rng = MT19937_64((seed + GOLDEN * (k + 1)) & MASK64)
                starts = np.array([rng() % self.n for _ in range(self.batch)], np.int64)
                nodes = np.unique(self._walk(starts, rng()))
                count[nodes] += 1
                seen += len(nodes)
            samples += per_chunk
            chunk += 1
        count[count == 0] = 0.1
        return (samples / count / self.n).astype(np.float32)

    def draw(self, count: int) -> List[Tuple[np.ndarray, np.ndarray, int, int]]:
        """The next ``count`` subgraphs of the training stream: (nodes, edge
        ids, and the pad sizes of the subgraph, which grow as the sampler's
        do)."""
        out = []
        for _ in range(count):
            nodes, eids = self._subgraph(self.rng)
            if len(nodes) > self.pad_nodes or len(eids) > self.pad_edges:
                self.pad_nodes = max(self.pad_nodes, _round_up(int(len(nodes) * 1.3) + 8, 64))
                self.pad_edges = max(self.pad_edges, _round_up(int(len(eids) * 1.3) + 8, 128))
            out.append((nodes, eids, self.pad_nodes, self.pad_edges))
        return out
