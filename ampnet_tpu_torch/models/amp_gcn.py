"""AMPGCN — tokenize -> 2x AMPConv -> pool -> classify.

Port of ``ampnet_tpu/models/amp_gcn.py`` with the ``raw_residual`` heads
('mlp', 'gcn', 'gcn2'): edge dropout -> tokenization -> (CLS token) ->
dropout -> AMPConv1 -> ReLU -> dropout -> AMPConv2 -> ReLU -> dropout ->
token mean-pool (or the CLS token) -> linear head -> log_softmax. With
``transformer_block`` the two convs sit in the JAX package's pre-LN blocks
instead, x = dropout(x) + conv(LN(x)) then x = x + ELU(post_conv_linear{i}
(LN(x))), the LayerNorms without scale or bias and at flax's epsilon,
1e-6. ``deterministic=True`` (evaluation) applies no dropout;
``deterministic=False`` (training) draws every mask from the generator it
is given.

``forward`` returns the log-prob tensor; with ``return_aux=True`` a
``ModelOutput(logits, aux)`` with the JAX package's aux keys. (The JAX
model's default is ``return_aux=True``; the port's steps and captured
graphs read the tensor, so its default is False.)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.models.layers import AMPConv, GCNConv, dropout, dropout_edges
from ampnet_tpu_torch.models.tokenizer import FeatureTokenizer
from ampnet_tpu_torch.ops.hopper.format import EdgeLayout
from ampnet_tpu_torch.ops.tokenize import standardize


# flax LayerNorm's epsilon (torch's default is 1e-5)
LAYER_NORM_EPS = 1e-6


@dataclass
class ModelOutput:
    logits: torch.Tensor                     # [N, C] log-probs (or sigmoid probs)
    aux: Dict[str, Any] = field(default_factory=dict)


def _lecun_normal_(linear: nn.Linear, generator: torch.Generator) -> None:
    """flax Dense's default init: lecun-normal kernel (a normal truncated at
    2 std, rescaled to unit variance), zero bias."""
    std = (1.0 / linear.in_features) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(linear.weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    linear.bias.zero_()


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
            if self.raw_mode == "mlp":
                _lecun_normal_(self.raw_residual_proj, generator)
        # drawn after every other parameter, so that a model without them
        # gets the same weights from the same generator as before
        if cfg.transformer_block:
            self.post_conv_linear1 = nn.Linear(d, d)
            self.post_conv_linear2 = nn.Linear(d, d)
            with torch.no_grad():
                _lecun_normal_(self.post_conv_linear1, generator)
                _lecun_normal_(self.post_conv_linear2, generator)
        if not cfg.average_pooling:
            self.cls_token = nn.Parameter(torch.empty(1, 1, d))
            with torch.no_grad():
                self.cls_token.normal_(0.0, 0.02, generator=generator)
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
        return_aux: bool = False,
    ) -> Union[torch.Tensor, ModelOutput]:
        """Log-probs [N, C] (sigmoid probs when softmax_out=False); with
        ``return_aux`` a ``ModelOutput`` whose aux holds ``sampled_idx``,
        each conv's head-averaged attention weights [E, S', S'] and output
        embedding, the pooled tokens and the raw residual (when the head
        has one). Token sampling draws from ``generator`` unless
        ``sampled_idx`` is given; with ``deterministic=False`` edge dropout
        and the dropouts draw from it too, in the order of the forward.
        ``edge_layout`` activates cfg.use_pallas (the attention weights then
        come from the plain weights-only pass on the side, as in the JAX
        package); ``fused_fns`` = (fn, fn), one fused call per conv
        (``train/pallas_step.py::make_fused_fns``), replaces the call each
        conv would build from the layout."""
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

        tokens, sidx = self.tokenizer(
            graph.x, node_mask=graph.node_mask, sampled_idx=sampled_idx,
            scaler_mean=self.scaler_mean, scaler_std=self.scaler_std,
            generator=generator)
        if not cfg.average_pooling:
            tokens = torch.cat([self.cls_token.expand(tokens.shape[0], 1, -1), tokens], dim=1)

        def conv(i, x):
            return (self.conv1, self.conv2)[i](
                x, graph.senders, graph.receivers, edge_mask, return_weights=return_aux,
                layout=edge_layout, fused_fn=None if fused_fns is None else fused_fns[i])

        attns, embs = [], []
        x = tokens
        if cfg.transformer_block:
            for i, linear in enumerate((self.post_conv_linear1, self.post_conv_linear2)):
                h, attn = conv(i, F.layer_norm(x, x.shape[-1:], eps=LAYER_NORM_EPS))
                attns.append(attn)
                embs.append(h)
                x = dropout(x, rate, generator) + h                  # b{i}
                h = linear(F.layer_norm(x, x.shape[-1:], eps=LAYER_NORM_EPS))
                x = x + F.elu(h)
        else:
            for i in range(2):
                x = dropout(x, rate, generator)                      # d1, d2
                x, attn = conv(i, x)
                attns.append(attn)
                embs.append(x)
                x = torch.relu(x)
            x = dropout(x, rate, generator)                          # d3
        pooled = x.mean(dim=1) if cfg.average_pooling else x[:, 0]

        xr = None
        head_in = pooled
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
            head_in = torch.cat([pooled, xr], dim=-1)

        logits = self.final_linear_out(head_in)
        out = torch.log_softmax(logits, dim=-1) if cfg.softmax_out else torch.sigmoid(logits)
        if not return_aux:
            return out
        aux = {"sampled_idx": sidx, "attn_weights_1": attns[0], "attn_weights_2": attns[1],
               "conv1_embedding": embs[0], "conv2_embedding": embs[1], "pooled": pooled}
        if xr is not None:
            aux["raw_residual"] = xr
        return ModelOutput(out, aux)
