"""Synthetic dataset generators (``ampnet_tpu/data/synthetic.py`` for the
port): fuzzy XOR, duplicated-feature XOR, random-partition (RPG) community
graphs with RGB features, and cyclic cellular-automata graphs.

Host numpy on a seeded ``np.random.Generator``, drawn in the JAX package's
order, so that every generator is array-equal to the JAX package's for the
same seed. The graphs come out as the port's padded ``Graph`` (CPU tensors,
``core/graph.py::from_arrays``). Reference generators:
  * create_xor_data            — synthetic_benchmark/synthetic_xor.py:104-165
  * create_duplicated_xor_data — synthetic_benchmark/synthetic_xor.py:24-101
  * random_partition_graph     — synthetic_benchmark/synthetic_rpg.py:39-121
  * rpg_rgb_features           — synthetic_benchmark/synthetic_rpg.py:127-152
  * the cyclic CA graph        — synthetic_benchmark/synthetic_rgb.py:12-147
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ampnet_tpu_torch.core.graph import Graph, from_arrays


def _edges_from_adj(adj: np.ndarray) -> np.ndarray:
    src, dst = np.nonzero(adj)
    return np.stack([src, dst]).astype(np.int32)


def create_xor_data(
    num_samples: int,
    noise_std: float = 0.1,
    same_class_link_prob: float = 0.7,
    diff_class_link_prob: float = 0.1,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fuzzy-XOR node classification on a class-probability-linked graph.

    Returns (x [N,2], y [N], adj [N,N], edge_index [2,E]) — same contract as
    the reference (synthetic_xor.py:104-165): balanced quadrants, gaussian
    feature noise, directed edges with P(link) depending on label equality,
    no self loops.
    """
    assert num_samples % 4 == 0, "num_samples must be an integer divisible by 4."
    assert 0.0 <= same_class_link_prob < 1.0
    assert 0.0 <= diff_class_link_prob < 1.0
    rng = rng or np.random.default_rng()
    repeats = num_samples // 4

    x = np.repeat(np.array([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=np.float64), repeats, axis=0)
    y = np.repeat(np.array([0.0, 1.0, 1.0, 0.0]), repeats)
    x = x + rng.normal(0.0, noise_std, size=(num_samples, 2))

    same = y[:, None] == y[None, :]
    p = np.where(same, same_class_link_prob, diff_class_link_prob)
    adj = (rng.random((num_samples, num_samples)) < p).astype(np.uint8)
    np.fill_diagonal(adj, 0)  # no self loops
    return x.astype(np.float32), y.astype(np.float32), adj, _edges_from_adj(adj)


def create_duplicated_xor_data(
    num_samples: int,
    noise_std: float = 0.1,
    num_nearest_neighbors: int = 10,
    feature_repeats: int = 5,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Duplicated-feature XOR: features tiled `feature_repeats` times +
    gaussian noise; graph = k-nearest-neighbor including self-loops
    (synthetic_xor.py:24-101; self-inclusion noted at :75)."""
    assert num_samples % 4 == 0
    rng = rng or np.random.default_rng()
    repeats = num_samples // 4

    x = np.repeat(np.array([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=np.float64), repeats, axis=0)
    y = np.repeat(np.array([0.0, 1.0, 1.0, 0.0]), repeats)
    x = np.tile(x, (1, feature_repeats))
    x = x + rng.normal(0.0, noise_std, size=x.shape)

    # kNN graph (euclidean), neighbor set includes self (k+1 nearest).
    d2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)
    nn_idx = np.argsort(d2, axis=1, kind="stable")[:, : num_nearest_neighbors + 1]
    adj = np.zeros((num_samples, num_samples), dtype=np.uint8)
    rows = np.repeat(np.arange(num_samples), num_nearest_neighbors + 1)
    adj[rows, nn_idx.ravel()] = 1
    return x.astype(np.float32), y.astype(np.float32), adj, _edges_from_adj(adj)


def random_partition_graph(
    n_groups: int,
    n_vertices: int,
    homophily: float,
    heterophily: float,
    rng: Optional[np.random.Generator] = None,
    directed: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random partition (community) graph (synthetic_rpg.py:39-121):
    undirected edges, intra-group prob `homophily`, inter-group prob
    `heterophily`. Returns (adj [N,N] symmetric uint8, labels [N])."""
    rng = rng or np.random.default_rng()
    n = n_groups * n_vertices
    labels = np.repeat(np.arange(n_groups), n_vertices)
    same = labels[:, None] == labels[None, :]
    p = np.where(same, homophily, heterophily)
    upper = np.triu(rng.random((n, n)) < p, k=1)
    adj = (upper | upper.T).astype(np.uint8)
    if directed:
        lower = np.tril(rng.random((n, n)) < p, k=-1)
        adj = (upper | lower).astype(np.uint8)
        np.fill_diagonal(adj, 0)
    return adj, labels


def rpg_rgb_features(
    adj: np.ndarray,
    n_groups: int,
    n_vertices: int,
    max_index: int = 255,
) -> np.ndarray:
    """RGB features from edge structure (synthetic_rpg.py:127-152): for each
    node, color channel c = (max_index / deg) * (#edges into group c).
    Assumes n_groups == 3 color groups like the reference."""
    deg = adj.sum(axis=1).astype(np.float64)
    safe_deg = np.maximum(deg, 1.0)
    feats = np.zeros((adj.shape[0], n_groups), dtype=np.float64)
    for g in range(n_groups):
        block = adj[:, g * n_vertices : (g + 1) * n_vertices].sum(axis=1)
        feats[:, g] = (max_index / safe_deg) * block
    return feats.astype(np.float32)


def make_rpg_graph(
    n_groups: int = 3,
    n_vertices: int = 10,
    homophily: float = 0.7,
    heterophily: float = 0.2,
    max_index: int = 255,
    rng: Optional[np.random.Generator] = None,
    **pad_kwargs,
) -> Graph:
    """RPG community graph with RGB features as a padded Graph."""
    adj, labels = random_partition_graph(n_groups, n_vertices, homophily, heterophily, rng)
    x = rpg_rgb_features(adj, n_groups, n_vertices, max_index)
    return from_arrays(x, _edges_from_adj(adj), y=labels, **pad_kwargs)


def get_xor_graphs(
    num_train_samples: int = 400,
    num_test_samples: int = 400,
    noise_std: float = 0.3,
    same_class_link_prob: float = 0.7,
    diff_class_link_prob: float = 0.1,
    seed: int = 0,
    **pad_kwargs,
) -> Tuple[Graph, Graph]:
    """Train+test XOR Graph pair (xor_training_utils.py:10-30 contract)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for ns in (num_train_samples, num_test_samples):
        x, y, _, ei = create_xor_data(ns, noise_std, same_class_link_prob, diff_class_link_prob, rng)
        graphs.append(
            from_arrays(
                x, ei, y=y.astype(np.int32),
                train_mask=np.ones(ns, bool), **pad_kwargs,
            )
        )
    return tuple(graphs)


def get_duplicated_xor_graphs(
    num_train_samples: int = 400,
    num_test_samples: int = 400,
    noise_std: float = 0.3,
    num_nearest_neighbors: int = 10,
    feature_repeats: int = 5,
    seed: int = 0,
    **pad_kwargs,
) -> Tuple[Graph, Graph]:
    """Train+test duplicated-feature XOR pair (xor_training_utils.py:33-53)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for ns in (num_train_samples, num_test_samples):
        x, y, _, ei = create_duplicated_xor_data(
            ns, noise_std, num_nearest_neighbors, feature_repeats, rng
        )
        graphs.append(
            from_arrays(
                x, ei, y=y.astype(np.int32),
                train_mask=np.ones(ns, bool), **pad_kwargs,
            )
        )
    return tuple(graphs)


# -- cyclic cellular-automata graph (synthetic_rgb.py:12-91) ---------------

def evolve_cyclic_ca(
    state: np.ndarray,
    num_colors: int,
    steps: int,
) -> np.ndarray:
    """Advance a 2-D cyclic cellular automaton `steps` times.

    Rule (reference rule table, synthetic_rgb.py:22-33): a cell at color c
    advances to (c+1) mod k iff any von-Neumann neighbor already has that
    color, else stays. Vectorized with periodic boundaries (the
    reference's cellpylib evolve2d default) — no 6^5-entry rule dict.
    """
    s = state
    for _ in range(steps):
        nxt = (s + 1) % num_colors
        neighbor_has_next = np.zeros_like(s, dtype=bool)
        for shift, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
            neighbor_has_next |= np.roll(s, shift, axis=axis) == nxt
        s = np.where(neighbor_has_next, nxt, s)
    return s


def create_cyclic_ca_graph(
    num_colors: int = 6,
    grid_size: int = 30,
    num_timesteps: int = 32,
    warmup: int = 1000,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cyclic-CA time-series graph — COMPLETED (the reference's
    create_multicolor_cyclic_cellular_automata_graph builds everything
    then `return None  # ToDo`, synthetic_rgb.py:12-91).

    Cells of a grid_size^2 torus evolve under the cyclic rule; after
    `warmup` steps the automaton settles into rotating spiral waves. Node
    features are each cell's color time series over `num_timesteps`
    post-warmup steps; the graph is the 4-neighbor grid adjacency with
    self loops (reference intent; its adj loop indexed [row, col±1]
    instead of [cell, neighbor] — fixed, not replicated). The label is
    the cell's color at the step after the recorded window, making
    next-state prediction a learnable node-classification task.

    Returns (node_features [N, T] float32, edge_index [2, E], y [N]).
    """
    rng = rng or np.random.default_rng()
    state = rng.integers(0, num_colors, size=(grid_size, grid_size))
    state = evolve_cyclic_ca(state, num_colors, warmup)

    frames = []
    for _ in range(num_timesteps):
        state = evolve_cyclic_ca(state, num_colors, 1)
        frames.append(state.copy())
    y = evolve_cyclic_ca(state, num_colors, 1)

    # [T, H, W] -> [H*W, T]
    feats = np.stack(frames).reshape(num_timesteps, -1).T.astype(np.float32)

    n = grid_size * grid_size
    idx = np.arange(n).reshape(grid_size, grid_size)
    src, dst = [idx.ravel()], [idx.ravel()]        # self loops
    for shift, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
        src.append(idx.ravel())
        dst.append(np.roll(idx, shift, axis=axis).ravel())
    edge_index = np.stack([np.concatenate(src), np.concatenate(dst)]).astype(np.int32)
    return feats, edge_index, y.ravel().astype(np.int64)


# Reference per-color (R, G, B) weight table (synthetic_rgb.py:139-142).
_CA_COLOR_WEIGHTS = np.array(
    [
        [150, 50, 55],
        [180, 300, 45],
        [60, 170, 25],
        [75, 160, 20],
        [10, 60, 185],
        [40, 80, 135],
    ],
    dtype=np.float64,
)


def color_histogram_embedding(
    node_features: np.ndarray,
    num_colors: int = 6,
) -> np.ndarray:
    """Color-histogram -> RGB feature embedding (reference
    feature_embedding, synthetic_rgb.py:98-147), vectorized.

    Per node: count occurrences of each color in its time series, take
    weighted R/G/B sums with the reference's per-color weight table, then
    normalize each channel to a 0-255 share. Returns [N, 3] float32.
    """
    if num_colors > _CA_COLOR_WEIGHTS.shape[0]:
        raise ValueError(
            f"weight table covers {_CA_COLOR_WEIGHTS.shape[0]} colors, "
            f"got num_colors={num_colors}"
        )
    nf = np.asarray(node_features).astype(np.int64)
    n = nf.shape[0]
    hist = np.zeros((n, num_colors), dtype=np.float64)
    for c in range(num_colors):
        hist[:, c] = (nf == c).sum(axis=1)
    rgb = hist @ _CA_COLOR_WEIGHTS[:num_colors]        # [N, 3]
    total = np.maximum(rgb.sum(axis=1, keepdims=True), 1e-12)
    return (255.0 * rgb / total).astype(np.float32)


def make_cyclic_ca_graph(
    num_colors: int = 6,
    grid_size: int = 30,
    num_timesteps: int = 32,
    embed: str = "histogram",   # 'histogram' (RGB embedding) | 'raw'
    train_frac: float = 0.7,
    rng: Optional[np.random.Generator] = None,
    **pad_kwargs,
) -> Graph:
    """Cyclic-CA dataset as a padded Graph (features per `embed`, label =
    next cell state, random train/test split)."""
    rng = rng or np.random.default_rng()
    feats, edge_index, y = create_cyclic_ca_graph(
        num_colors, grid_size, num_timesteps, rng=rng
    )
    x = color_histogram_embedding(feats, num_colors) if embed == "histogram" else feats
    n = x.shape[0]
    train_mask = rng.random(n) < train_frac
    return from_arrays(
        x, edge_index, y=y, train_mask=train_mask, test_mask=~train_mask,
        **pad_kwargs,
    )
