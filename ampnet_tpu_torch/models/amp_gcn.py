"""AMPGCN — tokenize -> 2x AMPConv -> mean-pool -> classify.

Port of the plain-stack, average-pooling model of
``ampnet_tpu/models/amp_gcn.py`` with the ``raw_residual`` heads ('mlp',
'gcn', 'gcn2'): edge dropout -> tokenization -> dropout -> AMPConv1 ->
ReLU -> dropout -> AMPConv2 -> ReLU -> dropout -> token mean-pool ->
linear head -> log_softmax. ``deterministic=True`` (evaluation) applies no
dropout; ``deterministic=False`` (training) draws every mask from the
generator it is given. The transformer block and CLS pooling are not
ported yet and raise.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.models.layers import AMPConv, GCNConv, dropout, dropout_edges
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
        deterministic: bool = True,
        sampled_idx: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        edge_layout: Optional[EdgeLayout] = None,
        fused_fns: Optional[Sequence[Callable]] = None,
    ) -> torch.Tensor:
        """Log-probs [N, C] (sigmoid probs when softmax_out=False).
        Token sampling draws from ``generator`` unless ``sampled_idx`` is
        given; with ``deterministic=False`` edge dropout and the dropouts
        draw from it too, in the order of the forward. ``edge_layout``
        activates cfg.use_pallas; ``fused_fns`` = (fn, fn), one fused call
        per conv (``train/pallas_step.py::make_fused_fns``), replaces the
        call each conv would build from the layout."""
        cfg = self.config
        edge_mask = graph.edge_mask
        rate = 0.0 if deterministic else cfg.dropout_rate
        adj_rate = 0.0 if deterministic else cfg.dropout_adj_rate
        if (rate > 0.0 or adj_rate > 0.0) and generator is None:
            raise ValueError("deterministic=False with a dropout rate > 0 draws "
                             "its masks from an explicit generator: pass one")

        # edge dropout (training only): the dropped mask is what every
        # consumer sees: both convs' validity slots (receiver and sender
        # side), their degree counts, and the GCN hops of the head
        if adj_rate > 0.0:
            if fused_fns is not None:
                raise ValueError(
                    "dropout_adj_rate > 0 on the fused path requires an "
                    "EdgeLayout (edge_layout=...): fused_fns closures read only "
                    "structural validity")
            edge_mask = dropout_edges(generator, edge_mask, adj_rate)

        tokens, _ = self.tokenizer(
            graph.x, node_mask=graph.node_mask, sampled_idx=sampled_idx,
            scaler_mean=self.scaler_mean, scaler_std=self.scaler_std,
            generator=generator)
        x = tokens
        for i, conv in enumerate((self.conv1, self.conv2)):
            x = dropout(x, rate, generator)                      # d1, d2
            x, _ = conv(x, graph.senders, graph.receivers, edge_mask,
                        return_weights=False, layout=edge_layout,
                        fused_fn=None if fused_fns is None else fused_fns[i])
            x = torch.relu(x)
        x = dropout(x, rate, generator)                          # d3
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
                    xr = dropout(xr, rate, generator)            # draw1
                    xr = torch.relu(self.raw_residual_conv2(
                        xr, graph.senders, graph.receivers, edge_mask))
            xr = dropout(xr, rate, generator)                    # draw
            head_in = torch.cat([head_in, xr], dim=-1)

        logits = self.final_linear_out(head_in)
        if cfg.softmax_out:
            return torch.log_softmax(logits, dim=-1)
        return torch.sigmoid(logits)
