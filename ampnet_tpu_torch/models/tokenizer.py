"""Feature tokenizer: scalar features -> vector tokens
(``ampnet_tpu/models/tokenizer.py`` for the port). Two frontends:

  * 'table': a learnable feature-identity embedding table (a parameter)
    concatenated with the z-scored value;
  * 'pca': the PCA-of-transpose feature embedding
    (``ops/tokenize.py::pca_feature_embedding``), computed once per dataset
    and held as a constant buffer, not a parameter.

Tokens are a sample of S features per node (uniform or TF-IDF with
replacement, or balanced 50/50 present/absent without replacement), or with
``downsample=False`` every feature, the table tiled ``feature_repeats``
times (the XOR path)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ampnet_tpu_torch.core.config import TokenizerConfig
from ampnet_tpu_torch.ops.tokenize import (
    balanced_sample_features,
    gather_tokens,
    sample_present_features,
    standardize,
    tfidf_sample_features,
    tile_all_tokens,
)


class FeatureTokenizer(nn.Module):
    """x [N, F] -> tokens [N, S, D], sampled indices [N, S] (None without
    downsampling).

    Token sampling draws from the ``generator`` passed to forward (or
    takes ``sampled_idx`` as given). ``pca_embedding`` [F, feat_emb_dim]:
    the 'pca' frontend's table."""

    def __init__(self, config: TokenizerConfig,
                 generator: Optional[torch.Generator] = None,
                 pca_embedding=None):
        super().__init__()
        if config.sampling not in ("uniform", "tfidf"):
            raise ValueError(f"unknown sampling {config.sampling!r}")
        if config.scaler not in ("batch", "precomputed", "none"):
            raise ValueError(f"unknown scaler {config.scaler!r}")
        self.config = config
        if config.frontend == "table":
            self.feature_embedding_table = nn.Parameter(
                torch.empty(config.num_node_features, config.feat_emb_dim))
            with torch.no_grad():   # torch nn.Embedding default N(0, 1)
                self.feature_embedding_table.normal_(generator=generator)
        elif config.frontend == "pca":
            if pca_embedding is None:
                raise ValueError("pca frontend requires a precomputed pca_embedding")
            self.register_buffer("pca_embedding", torch.as_tensor(
                np.asarray(pca_embedding), dtype=torch.float32), persistent=False)
        else:
            raise ValueError(f"unknown frontend {config.frontend!r}")

    def table(self) -> torch.Tensor:
        return (self.feature_embedding_table if self.config.frontend == "table"
                else self.pca_embedding)

    def forward(
        self,
        x: torch.Tensor,
        node_mask: Optional[torch.Tensor] = None,
        scaler_mean: Optional[torch.Tensor] = None,
        scaler_std: Optional[torch.Tensor] = None,
        sampled_idx: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.config
        if cfg.scaler == "none":
            x_norm = x
        elif cfg.scaler == "precomputed":
            if scaler_mean is None or scaler_std is None:
                raise ValueError(
                    "scaler='precomputed' requires scaler_mean and scaler_std; "
                    "a silent fallback to batch stats would normalize over "
                    "padded all-zero rows")
            x_norm = standardize(x, scaler_mean, scaler_std)
        else:
            x_norm = standardize(x, node_mask=node_mask)

        if not cfg.downsample:
            return tile_all_tokens(x_norm, self.table(), cfg.feature_repeats), None
        if sampled_idx is None:
            if cfg.balanced_sampling:
                sampled_idx = balanced_sample_features(
                    x, cfg.num_sampled_vectors, generator=generator)
            elif cfg.sampling == "tfidf":
                sampled_idx = tfidf_sample_features(
                    x, cfg.num_sampled_vectors, node_mask=node_mask, generator=generator)
            else:
                sampled_idx = sample_present_features(
                    x, cfg.num_sampled_vectors, generator=generator)
        return gather_tokens(x_norm, sampled_idx, self.table()), sampled_idx
