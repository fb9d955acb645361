"""Feature-tokenization math: z-scoring + token sampling.

Port of ``ampnet_tpu/ops/tokenize.py``. Randomness comes from an explicit
``torch.Generator``; the samplers also take precomputed uniforms ``u`` so
that a test can feed both packages the same draws. Balanced sampling
without replacement is Gumbel top-k, as in the JAX package, on Gumbel
noise from the torch generator (so its draws differ from JAX's, not its
distribution). The PCA feature embedding is host numpy, computed once per
dataset.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def fit_scaler(
    x: np.ndarray,
    node_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dataset-level StandardScaler fit (population std, host numpy), for
    scaler='precomputed': the same normalization at train and eval."""
    x = np.asarray(x, dtype=np.float32)
    if node_mask is not None:
        x = x[np.asarray(node_mask, dtype=bool)]
    return x.mean(axis=0).astype(np.float32), x.std(axis=0).astype(np.float32)


def standardize(
    x: torch.Tensor,
    mean: Optional[torch.Tensor] = None,
    std: Optional[torch.Tensor] = None,
    node_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Column z-scoring with sklearn StandardScaler semantics (population
    std, zero-variance columns scaled by 1). Given mean/std are used as
    they are; otherwise the stats come from the masked-in rows."""
    if mean is None or std is None:
        if node_mask is not None:
            w = node_mask.to(x.dtype)[:, None]
            n = w.sum().clamp_min(1.0)
            mean = (x * w).sum(0) / n
            var = (w * (x - mean) ** 2).sum(0) / n
        else:
            mean = x.mean(0)
            var = x.var(0, unbiased=False)
        std = var.sqrt()
    scale = torch.where(std == 0.0, torch.ones_like(std), std)
    return (x - mean) / scale


def _uniforms(shape, device, generator: Optional[torch.Generator],
              u: Optional[torch.Tensor]) -> torch.Tensor:
    if u is not None:
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniforms of shape {tuple(u.shape)}, expected {tuple(shape)}")
        return u.to(device=device, dtype=torch.float32)
    return torch.rand(shape, generator=generator, device=device)


def _inverse_cdf_sample(
    weights: torch.Tensor,   # [N, F] nonnegative, every row sum > 0
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,   # [N, num_samples] in [0, 1)
) -> torch.Tensor:
    """Weighted sampling WITH replacement via inverse-CDF lookup.

    idx = #{j : cdf_j <= u * total}: the first index whose cdf strictly
    exceeds the target, so zero-weight features are never selected. The
    clamp guards the measure-zero f32 case target == total.
    """
    cdf = torch.cumsum(weights, dim=1)
    u = _uniforms((weights.shape[0], num_samples), weights.device, generator, u)
    tgt = u * cdf[:, -1:]
    idx = torch.searchsorted(cdf.contiguous(), tgt.contiguous(), right=True)
    return idx.clamp_max(weights.shape[1] - 1)


def sample_present_features(
    x: torch.Tensor,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per node, `num_samples` indices uniform over the node's nonzero
    features, with replacement (amp_gcn.py:132-135); nodes with none fall
    back to uniform over all features. Returns [N, num_samples] int64."""
    present = x != 0
    any_present = present.any(dim=1, keepdim=True)
    weights = (present | ~any_present).to(torch.float32)
    return _inverse_cdf_sample(weights, num_samples, generator, u)


def tfidf_sample_features(
    x: torch.Tensor,
    num_samples: int,
    node_mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
    doc_freq: Optional[torch.Tensor] = None,
    num_rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per node, `num_samples` present features with replacement, weighted
    by TF-IDF (idf_j = log(N / (1 + df_j))). With `node_mask`, N is the
    REAL node count: the padded count would add log(N_pad/N_real) to every
    idf and flatten the weighting. ``doc_freq`` [F] and ``num_rows`` give
    df and N from elsewhere (the edge-partitioned forward's sums over the
    shards). Returns [N, num_samples] int64."""
    present = x != 0
    n_real = (num_rows if num_rows is not None
              else node_mask.to(torch.float32).sum() if node_mask is not None
              else torch.full((), float(x.shape[0]), device=x.device))
    df = doc_freq if doc_freq is not None else present.sum(dim=0).to(torch.float32)
    idf = torch.log(n_real / (1.0 + df))
    weights = x.abs() * idf.clamp_min(1e-3)[None, :]
    any_present = present.any(dim=1, keepdim=True)
    weights = torch.where(present, weights, torch.zeros_like(weights))
    weights = torch.where(any_present, weights, torch.ones_like(weights))
    return _inverse_cdf_sample(weights, num_samples, generator, u)


def gather_tokens(
    x_norm: torch.Tensor,
    sampled_idx: torch.Tensor,
    feat_embedding: torch.Tensor,
) -> torch.Tensor:
    """token[n, s] = concat(feat_embedding[idx[n,s]], x_norm[n, idx[n,s]])
    (amp_gcn.py:145-146). Returns [N, S, feat_dim + 1]."""
    idx = sampled_idx.long()
    emb = feat_embedding[idx]
    vals = torch.take_along_dim(x_norm, idx, dim=1)
    return torch.cat([emb, vals[..., None]], dim=-1)


def balanced_sample_features(
    x: torch.Tensor,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,   # [N, F] in [0, 1)
) -> torch.Tensor:
    """Per node, ``num_samples`` indices WITHOUT replacement, the probability
    mass split 50/50 between present (nonzero) and absent features
    (amp_gcn.py:208-231; a node with none of one kind gives all the mass to
    the other), by Gumbel top-k (Plackett-Luce: the distribution of
    np.random.choice(replace=False, p=...)). Returns [N, num_samples] int64."""
    n, f = x.shape
    present = x != 0
    n_present = present.sum(dim=1, keepdim=True).to(torch.float32)
    n_absent = f - n_present
    p_present = torch.where(n_present > 0, 0.5 / n_present.clamp_min(1.0),
                            torch.zeros_like(n_present))
    p_absent = torch.where(n_absent > 0, 0.5 / n_absent.clamp_min(1.0),
                           torch.zeros_like(n_absent))
    probs = torch.where(present, p_present, p_absent)
    probs = probs / probs.sum(dim=1, keepdim=True)
    logp = torch.log(probs.clamp_min(1e-30))
    u = _uniforms((n, f), x.device, generator, u)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.topk(logp + gumbel, num_samples, dim=1).indices


def tile_all_tokens(
    x_norm: torch.Tensor,
    feat_embedding: torch.Tensor,
    feature_repeats: int,
) -> torch.Tensor:
    """The non-downsampled XOR path: the whole table tiled
    ``feature_repeats`` times, every feature value attached
    (amp_gcn.py:168-180). Tiled token j carries feature j % F: the values
    are tiled to match the table's rows. Returns
    [N, table_rows * feature_repeats, feat_dim + 1]."""
    n = x_norm.shape[0]
    table = feat_embedding.repeat(feature_repeats, 1)          # [S, feat_dim]
    s = table.shape[0]
    emb = table[None].expand(n, s, table.shape[1])
    vals = x_norm.repeat(1, feature_repeats)[:, :s]
    return torch.cat([emb, vals[..., None].to(emb.dtype)], dim=-1)


def pca_feature_embedding(x: np.ndarray, n_components: int) -> np.ndarray:
    """PCA of the transposed feature matrix, rows = features, columns = nodes
    (amp_gcn.py:185-206 / utils/preprocess.py:8-26), on the host in float64
    by an economy SVD. Returns [F, n_components] float32."""
    xt = np.asarray(x, dtype=np.float64).T      # [F, N]
    xt = xt - xt.mean(axis=0, keepdims=True)    # sklearn PCA centers columns
    u, sv, _ = np.linalg.svd(xt, full_matrices=False)
    return (u[:, :n_components] * sv[:n_components]).astype(np.float32)
