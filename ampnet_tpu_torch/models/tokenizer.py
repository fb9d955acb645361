"""Feature tokenizer: scalar features -> vector tokens (the 'table'
frontend of ``ampnet_tpu/models/tokenizer.py``): a learnable
feature-identity embedding table concatenated with the z-scored value."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ampnet_tpu_torch.core.config import TokenizerConfig
from ampnet_tpu_torch.ops.tokenize import (
    gather_tokens,
    sample_present_features,
    standardize,
    tfidf_sample_features,
)


class FeatureTokenizer(nn.Module):
    """x [N, F] -> tokens [N, S, D], sampled indices [N, S].

    Token sampling draws from the ``generator`` passed to forward (or
    takes ``sampled_idx`` as given)."""

    def __init__(self, config: TokenizerConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.frontend != "table":
            raise NotImplementedError(f"frontend {config.frontend!r} is not ported yet")
        if not config.downsample or config.balanced_sampling:
            raise NotImplementedError(
                "only downsampled uniform/tfidf token sampling is ported yet")
        if config.sampling not in ("uniform", "tfidf"):
            raise ValueError(f"unknown sampling {config.sampling!r}")
        if config.scaler not in ("batch", "precomputed", "none"):
            raise ValueError(f"unknown scaler {config.scaler!r}")
        self.config = config
        self.feature_embedding_table = nn.Parameter(
            torch.empty(config.num_node_features, config.feat_emb_dim))
        with torch.no_grad():   # torch nn.Embedding default N(0, 1)
            self.feature_embedding_table.normal_(generator=generator)

    def forward(
        self,
        x: torch.Tensor,
        node_mask: Optional[torch.Tensor] = None,
        scaler_mean: Optional[torch.Tensor] = None,
        scaler_std: Optional[torch.Tensor] = None,
        sampled_idx: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
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

        if sampled_idx is None:
            if cfg.sampling == "tfidf":
                sampled_idx = tfidf_sample_features(
                    x, cfg.num_sampled_vectors, node_mask=node_mask, generator=generator)
            else:
                sampled_idx = sample_present_features(
                    x, cfg.num_sampled_vectors, generator=generator)
        return gather_tokens(x_norm, sampled_idx, self.feature_embedding_table), sampled_idx
