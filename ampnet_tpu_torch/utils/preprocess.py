"""The legacy PCA preprocessor (``ampnet_tpu/utils/preprocess.py`` for the
port), host numpy: ``embed_features_old`` (reference
src/ampnet/utils/preprocess.py:8-26), the original tokenization frontend
before the embedding table: each feature's PCA-of-transpose embedding
concatenated with its repeated raw value, flattened, z-scored per column.
It makes the pre-embedded token input of ``AMPNetClassifier``."""
from __future__ import annotations

import numpy as np

from ampnet_tpu_torch.ops.tokenize import pca_feature_embedding


def embed_features_old(
    x: np.ndarray,
    feature_embed_dim: int = 5,
    value_embed_dim: int = 1,
) -> np.ndarray:
    """x [N, F] -> flattened tokens [N, F * (feat_dim + val_dim)]:
    token(n, f) = concat(PCA(x^T)[f], repeat(x[n, f], value_embed_dim)),
    then each output column z-scored (population std, zero variance -> 1)."""
    x = np.asarray(x, dtype=np.float32)
    n, f = x.shape
    emb = pca_feature_embedding(x, feature_embed_dim)          # [F, feat_dim]
    emb_rep = np.broadcast_to(emb[None], (n, f, feature_embed_dim))
    vals = np.repeat(x[..., None], value_embed_dim, axis=-1)   # [N, F, val_dim]
    flat = np.concatenate([emb_rep, vals], axis=-1).reshape(
        n, f * (feature_embed_dim + value_embed_dim))
    mean = flat.mean(axis=0)
    std = flat.std(axis=0)
    std[std == 0] = 1.0
    return ((flat - mean) / std).astype(np.float32)


# the name the reference's later imports use
embed_features = embed_features_old
