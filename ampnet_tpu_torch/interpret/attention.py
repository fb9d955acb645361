"""Attention-coefficient extraction and heatmaps
(``ampnet_tpu/interpret/attention.py`` in the port).

The reference's Cora attention-coefficient script and its synthetic XOR
counterpart, on top of the model's aux outputs: the head-averaged attention
weights [E, S, S] and the sampled feature indices [N, S] come back from
``AMPGCN(..., return_aux=True)`` instead of being cached on modules. The
per-edge accumulation is vectorized with ``np.add.at``. Every number is
numpy (``attention_heatmaps``); matplotlib and seaborn are imported when a
plot is drawn.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ampnet_tpu_torch.interpret.curves import pyplot


def incoming_edge_attention(
    senders: np.ndarray,
    receivers: np.ndarray,
    attn_weights: np.ndarray,    # [E, S, S] head-averaged
    node: int,
    y: Optional[np.ndarray] = None,
    edge_mask: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Per-node incoming-edge attention view: the ids of the (real) edges
    into ``node``, their senders and [k, S, S] attention slices, and the
    senders' labels when ``y`` is given.

    Returns {'edge_ids', 'neighbors', 'attention'[, 'neighbor_labels']}.
    """
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    valid = receivers == node
    if edge_mask is not None:
        # int / float masks (layout-derived validity) as bool first
        valid &= np.asarray(edge_mask).astype(bool)
    edge_ids = np.where(valid)[0]
    out = {
        "edge_ids": edge_ids,
        "neighbors": senders[edge_ids],
        "attention": np.asarray(attn_weights)[edge_ids],
    }
    if y is not None:
        out["neighbor_labels"] = np.asarray(y)[senders[edge_ids]]
    return out


def top_k_features_for_class(
    x: np.ndarray, y: np.ndarray, cls: int, k: int = 30
) -> np.ndarray:
    """Indices of the k most-present features among nodes of ``cls``."""
    counts = (x[y == cls] != 0).sum(axis=0)
    return np.argsort(-counts, kind="stable")[:k]


def calculate_attn_heatmap(
    attn_weights: np.ndarray,    # [E, S, S] head-averaged
    sampled_idx: np.ndarray,     # [N, S]
    senders: np.ndarray,         # [E]
    receivers: np.ndarray,       # [E]
    edge_mask: np.ndarray,       # [E]
    y: np.ndarray,               # [N]
    src_class: int,
    dst_class: int,
    src_top: np.ndarray,         # [K] feature ids
    dst_top: np.ndarray,         # [K]
) -> Tuple[np.ndarray, np.ndarray]:
    """Mean attention per (dst-feature row, src-feature column) over the
    edges of a class pair. Returns (heatmap [K, K], counts [K, K])."""
    k = len(src_top)
    src_pos = np.full(int(max(sampled_idx.max(), src_top.max(), dst_top.max())) + 1, -1, np.int64)
    dst_pos = src_pos.copy()
    src_pos[src_top] = np.arange(k)
    dst_pos[dst_top] = np.arange(k)

    sel = (np.asarray(edge_mask).astype(bool)
           & (y[senders] == src_class) & (y[receivers] == dst_class))
    eids = np.nonzero(sel)[0]
    heat = np.zeros((k, k))
    counts = np.zeros((k, k))
    if len(eids) == 0:
        return heat, counts

    w = attn_weights[eids]                            # [e, S, S]
    dst_tok = dst_pos[sampled_idx[receivers[eids]]]   # [e, S] row positions
    src_tok = src_pos[sampled_idx[senders[eids]]]     # [e, S] col positions
    e, s = dst_tok.shape
    rows = np.broadcast_to(dst_tok[:, :, None], (e, s, s))
    cols = np.broadcast_to(src_tok[:, None, :], (e, s, s))
    valid = (rows >= 0) & (cols >= 0)
    np.add.at(heat, (rows[valid], cols[valid]), w[valid])
    np.add.at(counts, (rows[valid], cols[valid]), 1.0)
    with np.errstate(invalid="ignore"):
        heat = np.where(counts > 0, heat / np.maximum(counts, 1), 0.0)
    return heat, counts


def plot_attn_heatmap(
    heat: np.ndarray,
    save_path: str,
    name: str,
    src_labels: Optional[Sequence] = None,
    dst_labels: Optional[Sequence] = None,
    clustermap: bool = True,
) -> str:
    """Save the raw .npy and a seaborn heatmap (and clustermap)."""
    os.makedirs(save_path, exist_ok=True)
    np.save(os.path.join(save_path, f"{name}.npy"), heat)
    plt = pyplot()
    import seaborn as sns

    fig, ax = plt.subplots(figsize=(10, 8))
    sns.heatmap(heat, ax=ax, cmap="viridis",
                xticklabels=src_labels if src_labels is not None else "auto",
                yticklabels=dst_labels if dst_labels is not None else "auto")
    ax.set_xlabel("Source node feature")
    ax.set_ylabel("Destination node feature")
    ax.set_title(name)
    out = os.path.join(save_path, f"{name}_heatmap.png")
    fig.savefig(out, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    if clustermap and heat.shape[0] > 1 and np.abs(heat).sum() > 0:
        try:
            cg = sns.clustermap(heat, cmap="viridis")
            cg.savefig(os.path.join(save_path, f"{name}_clustermap.png"))
            plt.close("all")
        except Exception:
            pass   # clustering a degenerate map fails in scipy; the heatmap stands
    return out


def attention_heatmaps(
    x: np.ndarray,
    y: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_mask: np.ndarray,
    attn_weights: np.ndarray,
    sampled_idx: np.ndarray,
    class_pairs: Optional[Sequence[Tuple[int, int]]] = None,
    top_k: int = 30,
) -> Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The numbers of ``visualize_attention_coefficients``: for each class
    pair (default: every pair), (heatmap [K, K], the source class's top-K
    features, the destination class's)."""
    n_classes = int(y.max()) + 1
    if class_pairs is None:
        class_pairs = [(a, b) for a in range(n_classes) for b in range(n_classes)]
    tops = {c: top_k_features_for_class(x, y, c, top_k) for c in range(n_classes)}
    out = {}
    for (cs, cd) in class_pairs:
        heat, _ = calculate_attn_heatmap(
            attn_weights, sampled_idx, senders, receivers, edge_mask, y,
            cs, cd, tops[cs], tops[cd],
        )
        out[(cs, cd)] = (heat, tops[cs], tops[cd])
    return out


def visualize_attention_coefficients(
    x: np.ndarray,
    y: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_mask: np.ndarray,
    attn_weights: np.ndarray,
    sampled_idx: np.ndarray,
    save_path: str,
    class_pairs: Optional[Sequence[Tuple[int, int]]] = None,
    top_k: int = 30,
) -> Dict[Tuple[int, int], np.ndarray]:
    """Heatmap per class pair (``attention_heatmaps``), each saved and drawn."""
    out = {}
    for (cs, cd), (heat, src_top, dst_top) in attention_heatmaps(
            x, y, senders, receivers, edge_mask, attn_weights, sampled_idx,
            class_pairs, top_k).items():
        plot_attn_heatmap(heat, save_path, f"attn_class{cs}_to_class{cd}",
                          src_labels=src_top, dst_labels=dst_top)
        out[(cs, cd)] = heat
    return out


def plot_xor_attn_weights(
    x: np.ndarray,               # [N, 2] XOR features
    y: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_mask: np.ndarray,
    attn_weights: np.ndarray,    # [E, S, S]
    save_path: str,
    bins: Tuple[float, float] = (-7.5, 7.5),
) -> str:
    """XOR variant: bucket edges by (src-quadrant, dst-quadrant) of the truth
    table and histogram the per-edge attention entries (the wide bin range
    covers the unbounded weights of a model without softmax)."""
    quad = (np.round(np.clip(x[:, 0], 0, 1)) * 2 + np.round(np.clip(x[:, 1], 0, 1))).astype(int)
    os.makedirs(save_path, exist_ok=True)
    plt = pyplot()
    fig, axes = plt.subplots(4, 4, figsize=(14, 12))
    eids = np.nonzero(edge_mask)[0]
    sq, dq = quad[senders[eids]], quad[receivers[eids]]
    for a in range(4):
        for b in range(4):
            ax = axes[a][b]
            sel = (sq == a) & (dq == b)
            vals = attn_weights[eids[sel]].reshape(-1)
            if len(vals):
                ax.hist(vals, bins=40, range=bins, density=True, color="C0")
            ax.set_title(f"src q{a} -> dst q{b}", fontsize=8)
    fig.suptitle("Per-edge attention entries by XOR quadrant pair")
    fig.tight_layout()
    out = os.path.join(save_path, "xor_attn_quadrants.png")
    fig.savefig(out, facecolor="white")
    plt.close(fig)
    return out
