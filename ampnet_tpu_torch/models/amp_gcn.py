"""AMPGCN — tokenize -> 2x AMPConv -> mean-pool -> classify (inference).

Port of the plain-stack, average-pooling forward of
``ampnet_tpu/models/amp_gcn.py`` with the ``raw_residual`` heads ('mlp',
'gcn', 'gcn2'). This is the deterministic forward that evaluation runs:
dropout and edge dropout are training-time and are not applied. The
transformer block and CLS pooling are not ported yet and raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.models.layers import AMPConv, GCNConv
from ampnet_tpu_torch.models.tokenizer import FeatureTokenizer
from ampnet_tpu_torch.ops.hopper.format import EdgeLayout
from ampnet_tpu_torch.ops.tokenize import standardize


def _raw_residual_mode(cfg: AMPGCNConfig):
    if not cfg.raw_residual:
        return None
    mode = cfg.raw_residual if isinstance(cfg.raw_residual, str) else "mlp"
    if mode not in ("mlp", "gcn", "gcn2"):
        raise ValueError(f"unknown raw_residual mode: {mode!r}")
    return mode


class AMPGCN(nn.Module):
    """Parameters are made on the CPU from ``generator`` (seed 0 when
    None), then moved to ``device``. ``scaler_stats`` = (mean, std) from
    ``ops.tokenize.fit_scaler`` for scaler='precomputed'."""

    def __init__(self, config: AMPGCNConfig,
                 scaler_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if config.transformer_block or not config.average_pooling:
            raise NotImplementedError(
                "the transformer block and CLS pooling are not ported yet")
        if config.compute_dtype != "float32":
            raise NotImplementedError("only float32 compute is ported yet")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = cfg = config
        d = cfg.embedding_dim
        self.tokenizer = FeatureTokenizer(cfg.tokenizer(), generator=generator)
        self.conv1 = AMPConv(d, cfg.num_heads, cfg.attn_softmax, cfg.use_pallas, generator)
        self.conv2 = AMPConv(d, cfg.num_heads, cfg.attn_softmax, cfg.use_pallas, generator)
        self.raw_mode = _raw_residual_mode(cfg)
        f = cfg.num_node_features
        if self.raw_mode == "mlp":
            self.raw_residual_proj = nn.Linear(f, d)
        elif self.raw_mode in ("gcn", "gcn2"):
            self.raw_residual_conv1 = GCNConv(f, d, generator)
            if self.raw_mode == "gcn2":
                self.raw_residual_conv2 = GCNConv(d, d, generator)
        head_in = 2 * d if self.raw_mode else d
        self.final_linear_out = nn.Linear(head_in, cfg.output_dim)
        with torch.no_grad():
            # head: xavier-uniform, zero bias (the JAX package's choice)
            nn.init.xavier_uniform_(self.final_linear_out.weight, generator=generator)
            self.final_linear_out.bias.zero_()
            if self.raw_mode == "mlp":   # flax Dense default: lecun-normal, zero bias
                std = (1.0 / f) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(self.raw_residual_proj.weight, std=std,
                                      a=-2 * std, b=2 * std, generator=generator)
                self.raw_residual_proj.bias.zero_()
        if scaler_stats is not None:
            mean, std = (torch.as_tensor(np.asarray(a), dtype=torch.float32)
                         for a in scaler_stats)
            self.register_buffer("scaler_mean", mean, persistent=False)
            self.register_buffer("scaler_std", std, persistent=False)
        else:
            self.scaler_mean = self.scaler_std = None
        self.to(device)

    def forward(
        self,
        graph: Graph,
        sampled_idx: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        edge_layout: Optional[EdgeLayout] = None,
    ) -> torch.Tensor:
        """Log-probs [N, C] (sigmoid probs when softmax_out=False).
        Token sampling draws from ``generator`` unless ``sampled_idx`` is
        given; ``edge_layout`` activates cfg.use_pallas."""
        cfg = self.config
        edge_mask = graph.edge_mask
        tokens, _ = self.tokenizer(
            graph.x, node_mask=graph.node_mask, sampled_idx=sampled_idx,
            scaler_mean=self.scaler_mean, scaler_std=self.scaler_std,
            generator=generator)
        x = tokens
        for conv in (self.conv1, self.conv2):
            x, _ = conv(x, graph.senders, graph.receivers, edge_mask,
                        return_weights=False, layout=edge_layout)
            x = torch.relu(x)
        head_in = x.mean(dim=1)

        if self.raw_mode:
            xr = standardize(graph.x, mean=self.scaler_mean, std=self.scaler_std,
                             node_mask=graph.node_mask)
            if self.raw_mode == "mlp":
                xr = torch.relu(self.raw_residual_proj(xr))
            else:
                xr = torch.relu(self.raw_residual_conv1(
                    xr, graph.senders, graph.receivers, edge_mask))
                if self.raw_mode == "gcn2":
                    xr = torch.relu(self.raw_residual_conv2(
                        xr, graph.senders, graph.receivers, edge_mask))
            head_in = torch.cat([head_in, xr], dim=-1)

        logits = self.final_linear_out(head_in)
        if cfg.softmax_out:
            return torch.log_softmax(logits, dim=-1)
        return torch.sigmoid(logits)
