"""A graph generator (``"generator": "cora_sbm"`` in a configuration's
``graph`` block): a frozen copy of the port's Cora-shaped surrogate
(``ampnet_tpu_torch/data/planetoid.py::synthetic_cora``), its sizes taken
from the configuration's ``graph`` block, so that the yardstick does not
move when the program's loader does. At Cora's sizes and the same seed it
draws the same graph as the original.

A stochastic block model: each class favours a block of words, about 19
words a node, 81% of the undirected edges inside a class, both directions
of each edge stored; 20 training nodes a class, then validation and test
nodes in order."""
from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.lib.graphs import GraphArrays


def make(g: Dict) -> GraphArrays:
    """The graph of a configuration's ``graph`` block, from its ``seed``."""
    rng = np.random.default_rng(g["seed"])
    n, f, c = g["nodes"], g["features"], g["classes"]
    sizes = np.asarray(g["class_sizes"])
    if sizes.size != c or int(sizes.sum()) != n:
        raise ValueError(f"class sizes {sizes.tolist()} do not make {n} nodes in {c} classes")
    y = np.repeat(np.arange(c), sizes)
    rng.shuffle(y)
    y = y.astype(np.int32)

    words = g["words_per_node"]
    x = np.zeros((n, f), dtype=np.float32)
    centers = rng.integers(0, f, size=c)
    for i in range(n):
        k = max(1, int(rng.normal(words, 6)))
        in_class = rng.normal(centers[y[i]], 120, size=2 * k).astype(int) % f
        uniform = rng.integers(0, f, size=k)
        chosen = np.concatenate([in_class[:k], uniform[: max(1, k // 3)]])
        x[i, np.unique(chosen)] = 1.0

    undirected = g["directed_edges"] // 2
    intra = int(g["intra_class_share"] * undirected)
    edges = set()
    by_class = [np.where(y == k)[0] for k in range(c)]
    while len(edges) < intra:
        k = rng.integers(0, c)
        u, v = rng.choice(by_class[k], 2, replace=False)
        edges.add((min(u, v), max(u, v)))
    while len(edges) < undirected:
        u, v = rng.integers(0, n, 2)
        if u != v:
            edges.add((min(u, v), max(u, v)))
    e = np.array(sorted(edges)).T
    edge_index = np.concatenate([e, e[::-1]], axis=1).astype(np.int32)

    train = np.zeros(n, bool)
    val = np.zeros(n, bool)
    test = np.zeros(n, bool)
    for k in range(c):
        train[by_class[k][: g["train_per_class"]]] = True
    rest = np.where(~train)[0]
    val[rest[: g["val"]]] = True
    test[rest[g["val"]: g["val"] + g["test"]]] = True
    return GraphArrays(x, y, edge_index, train, val, test)

