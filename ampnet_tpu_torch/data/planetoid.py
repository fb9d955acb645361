"""Planetoid (Cora) loader and its deterministic surrogate.

Host numpy, copied from ``ampnet_tpu/data/planetoid.py`` so that the port
builds array-equal data from the same seed: ``synthetic_cora`` is a
stochastic-block-model graph with Cora's sizes (2708 nodes, 10556
directed edges, 1433 binary features, 7 classes, 140/500/1000 split), and
``load_cora`` reads the raw Planetoid files from ``root`` when given, else
falls back to the surrogate.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Optional

import numpy as np

CORA_NUM_NODES = 2708
CORA_NUM_FEATURES = 1433
CORA_NUM_CLASSES = 7
CORA_NUM_EDGES = 10556  # directed


@dataclass
class PlanetoidData:
    x: np.ndarray           # [N, F] float32
    y: np.ndarray           # [N] int32
    edge_index: np.ndarray  # [2, E] int32, directed (both directions present)
    train_mask: np.ndarray  # [N] bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    name: str = "Cora"
    synthetic: bool = False

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_features(self) -> int:
        return self.x.shape[1]

    @property
    def num_classes(self) -> int:
        return int(self.y.max()) + 1


def _parse_index_file(path: str) -> np.ndarray:
    with open(path) as f:
        return np.array([int(line.strip()) for line in f], dtype=np.int64)


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_planetoid_raw(root: str, name: str = "cora") -> PlanetoidData:
    """Parse the standard Planetoid raw files (Yang et al. 2016 format)."""
    name = name.lower()
    objs = {}
    for suffix in ["x", "y", "tx", "ty", "allx", "ally", "graph"]:
        objs[suffix] = _load_pickle(os.path.join(root, f"ind.{name}.{suffix}"))
    test_idx = _parse_index_file(os.path.join(root, f"ind.{name}.test.index"))
    test_idx_range = np.sort(test_idx)

    def dense(m):
        return np.asarray(m.todense() if hasattr(m, "todense") else m, dtype=np.float32)

    allx, tx = dense(objs["allx"]), dense(objs["tx"])
    ally, ty = np.asarray(objs["ally"]), np.asarray(objs["ty"])

    # a test.index with gaps (Citeseer) zero-fills the full min..max range
    full_span = int(test_idx.max()) - int(test_idx.min()) + 1
    if full_span != len(test_idx):
        tx_ext = np.zeros((full_span, tx.shape[1]), tx.dtype)
        tx_ext[test_idx_range - int(test_idx.min())] = tx
        tx = tx_ext
        ty_ext = np.zeros((full_span, ty.shape[1]), ty.dtype)
        ty_ext[test_idx_range - int(test_idx.min())] = ty
        ty = ty_ext

    x = np.vstack([allx, tx])
    x[test_idx] = x[test_idx_range]
    labels_onehot = np.vstack([ally, ty])
    labels_onehot[test_idx] = labels_onehot[test_idx_range]
    y = labels_onehot.argmax(axis=1).astype(np.int32)

    n = x.shape[0]
    src, dst = [], []
    for node, nbrs in objs["graph"].items():
        for nbr in nbrs:
            if node != nbr:
                src.append(node)
                dst.append(nbr)
    edge_index = np.unique(np.stack([src, dst]), axis=1).astype(np.int32)

    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    y_len = objs["y"].shape[0]
    train_mask[:y_len] = True
    val_mask[y_len : min(y_len + 500, ally.shape[0])] = True
    test_mask[test_idx] = True
    return PlanetoidData(x, y, edge_index, train_mask, val_mask, test_mask, name=name)


def synthetic_cora(seed: int = 0) -> PlanetoidData:
    """Deterministic Cora-shaped surrogate (array-equal to the JAX
    package's for the same seed)."""
    rng = np.random.default_rng(seed)
    n, f, c = CORA_NUM_NODES, CORA_NUM_FEATURES, CORA_NUM_CLASSES
    sizes = np.array([351, 217, 418, 818, 426, 298, 180])  # Cora class sizes
    y = np.repeat(np.arange(c), sizes)
    rng.shuffle(y)
    y = y.astype(np.int32)

    # features: each class favors a block of ~300 words; ~19 words/node
    words_per_node = 19
    x = np.zeros((n, f), dtype=np.float32)
    class_centers = rng.integers(0, f, size=c)
    for i in range(n):
        k = max(1, int(rng.normal(words_per_node, 6)))
        in_class = rng.normal(class_centers[y[i]], 120, size=2 * k).astype(int) % f
        uniform = rng.integers(0, f, size=k)
        chosen = np.concatenate([in_class[:k], uniform[: max(1, k // 3)]])
        x[i, np.unique(chosen)] = 1.0

    # edges: SBM with 81% intra-class target
    target_undirected = CORA_NUM_EDGES // 2
    intra_target = int(0.81 * target_undirected)
    edges = set()
    by_class = [np.where(y == k)[0] for k in range(c)]
    while len(edges) < intra_target:
        k = rng.integers(0, c)
        u, v = rng.choice(by_class[k], 2, replace=False)
        edges.add((min(u, v), max(u, v)))
    while len(edges) < target_undirected:
        u, v = rng.integers(0, n, 2)
        if u != v:
            edges.add((min(u, v), max(u, v)))
    e = np.array(sorted(edges)).T
    edge_index = np.concatenate([e, e[::-1]], axis=1).astype(np.int32)

    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    for k in range(c):  # 20 per class for train, like Planetoid
        train_mask[by_class[k][:20]] = True
    rest = np.where(~train_mask)[0]
    val_mask[rest[:500]] = True
    test_mask[rest[500:1500]] = True
    return PlanetoidData(
        x, y, edge_index, train_mask, val_mask, test_mask, name="SyntheticCora", synthetic=True
    )


def load_cora(root: Optional[str] = None, seed: int = 0) -> PlanetoidData:
    """Cora from the raw files under ``root`` when they are there, else
    the synthetic surrogate."""
    if root and os.path.exists(os.path.join(root, "ind.cora.graph")):
        return load_planetoid_raw(root, "cora")
    return synthetic_cora(seed)
