"""Embedding-space plots: PCA / t-SNE / UMAP 2-D scatters and subgraph
drawings (``ampnet_tpu/interpret/embedding.py`` in the port). The
projections are numpy (sklearn for t-SNE, umap-learn when installed, else a
spectral neighbor embedding); matplotlib is imported when a plot is drawn."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ampnet_tpu_torch.interpret.curves import pyplot


def plot_pca_2d(
    embeddings: np.ndarray,
    labels: np.ndarray,
    save_path: str,
    name: str = "pca_2d",
) -> str:
    """2-D PCA scatter + cumulative explained-variance curve."""
    x = np.asarray(embeddings, np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    u, s, _ = np.linalg.svd(x, full_matrices=False)
    proj = u[:, :2] * s[:2]
    evr = (s**2) / np.sum(s**2)

    os.makedirs(save_path, exist_ok=True)
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    sc = ax1.scatter(proj[:, 0], proj[:, 1], c=labels, cmap="tab10", s=8)
    ax1.set_title(f"{name}: PCA 2D")
    fig.colorbar(sc, ax=ax1)
    ax2.plot(np.cumsum(evr))
    ax2.set_title("Cumulative explained variance")
    ax2.set_xlabel("Component")
    ax2.grid(alpha=0.3)
    out = os.path.join(save_path, f"{name}.png")
    fig.savefig(out, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    return out


def plot_tsne_2d(
    embeddings: np.ndarray,
    labels: np.ndarray,
    save_path: str,
    name: str = "tsne_2d",
    perplexity: float = 30.0,
) -> Optional[str]:
    """t-SNE scatter (sklearn, host-side only); None without sklearn."""
    try:
        from sklearn.manifold import TSNE
    except ImportError:
        return None
    n = len(embeddings)
    proj = TSNE(
        n_components=2, perplexity=min(perplexity, max(2, (n - 1) / 3)), init="pca"
    ).fit_transform(np.asarray(embeddings, np.float64))
    os.makedirs(save_path, exist_ok=True)
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 6))
    sc = ax.scatter(proj[:, 0], proj[:, 1], c=labels, cmap="tab10", s=8)
    fig.colorbar(sc, ax=ax)
    ax.set_title(f"{name}: t-SNE 2D")
    out = os.path.join(save_path, f"{name}.png")
    fig.savefig(out, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    return out


def _spectral_neighbor_embedding(x: np.ndarray, k: int = 15) -> np.ndarray:
    """2-D spectral embedding of the symmetrized kNN graph (a numpy-only
    UMAP stand-in: the same neighbor graph, Laplacian eigenmaps instead of
    the fuzzy-simplicial optimization)."""
    n = x.shape[0]
    k = min(k, n - 1)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1) if n <= 2048 else None
    if d2 is None:
        # blockwise distances for larger inputs
        d2 = np.empty((n, n), np.float64)
        for i in range(0, n, 1024):
            d2[i:i + 1024] = ((x[i:i + 1024, None, :] - x[None, :, :]) ** 2).sum(-1)
    nn_idx = np.argsort(d2, axis=1)[:, 1:k + 1]
    w = np.zeros((n, n), np.float64)
    rows = np.repeat(np.arange(n), k)
    w[rows, nn_idx.ravel()] = 1.0
    w = np.maximum(w, w.T)
    deg = np.maximum(w.sum(1), 1e-12)
    d_inv_sqrt = 1.0 / np.sqrt(deg)
    lap = np.eye(n) - d_inv_sqrt[:, None] * w * d_inv_sqrt[None, :]
    vals, vecs = np.linalg.eigh(lap)
    # skip the trivial (constant) eigenvector
    order = np.argsort(vals)
    return vecs[:, order[1:3]]


def plot_umap_2d(
    embeddings: np.ndarray,
    labels: np.ndarray,
    save_path: str,
    name: str = "umap_2d",
) -> Optional[str]:
    """UMAP scatter: umap-learn when installed, else the spectral neighbor
    embedding of the same kNN graph (name suffixed ``_spectral_fallback``),
    so that the plot is always made."""
    emb64 = np.asarray(embeddings, np.float64)
    try:
        import umap  # type: ignore

        proj = umap.UMAP(n_components=2).fit_transform(emb64)
    except ImportError:
        proj = _spectral_neighbor_embedding(emb64)
        name = f"{name}_spectral_fallback"
    os.makedirs(save_path, exist_ok=True)
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 6))
    sc = ax.scatter(proj[:, 0], proj[:, 1], c=labels, cmap="tab10", s=8)
    fig.colorbar(sc, ax=ax)
    ax.set_title(f"{name}: UMAP 2D")
    out = os.path.join(save_path, f"{name}.png")
    fig.savefig(out, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    return out


def plot_subgraph(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_mask: np.ndarray,
    labels: Optional[np.ndarray],
    save_path: str,
    name: str = "subgraph",
) -> Optional[str]:
    """Draw a sampled subgraph with networkx; None without networkx or edges."""
    try:
        import networkx as nx
    except ImportError:
        return None
    g = nx.DiGraph()
    em = np.asarray(edge_mask)
    for s, r in zip(np.asarray(senders)[em], np.asarray(receivers)[em]):
        g.add_edge(int(s), int(r))
    if g.number_of_nodes() == 0:
        return None
    pos = nx.spring_layout(g, seed=0)
    os.makedirs(save_path, exist_ok=True)
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 8))
    colors = None
    if labels is not None:
        colors = [labels[n] for n in g.nodes()]
    nx.draw_networkx_nodes(g, pos, node_color=colors, cmap=plt.get_cmap("coolwarm"),
                           node_size=60, ax=ax)
    nx.draw_networkx_edges(g, pos, arrows=False, alpha=0.3, ax=ax)
    out = os.path.join(save_path, f"{name}.png")
    fig.savefig(out, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    return out
