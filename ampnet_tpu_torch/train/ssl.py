"""Self-supervised pretraining heads (``ampnet_tpu/train/ssl.py`` in torch).

The reference ships two SSL scripts whose loss is a ``criterion = None``
stub; the intended GraphSAGE skip-gram objective is transcribed in their
comments. Implemented here as in the JAX package:

  * contrastive (skip-gram): for each edge (u, v),
      L = -log sigmoid(z_u . z_v) - Q * E_neg[log sigmoid(-z_u . z_n)]
    with Q negatives per positive, uniform over the valid nodes;
  * predictive: reconstruct which node features are present from the
    pooled embedding.

The negatives are drawn with static shapes (no ``nonzero``, no
``multinomial``), so that the draw sits inside a captured CUDA graph: a
uniform integer below the number of valid nodes, mapped to that valid node
through the running count of the node mask. The JAX package draws them
from ``fold_in(state.rng, 77)``; the port draws them from the state's one
generator, after the backbone's own draws, so the two are held against
each other by their distribution, and bit for bit only where a test injects
JAX's negatives (``neg_idx``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.models.amp_gcn import _lecun_normal_
from ampnet_tpu_torch.ops.hopper.format import EdgeLayout
from ampnet_tpu_torch.train.state import TrainState, _captured_train_step, _on_card

MODES = ("contrastive", "predictive")


def draw_negatives(generator: Optional[torch.Generator], num_edges: int, num_negatives: int,
                   num_nodes: int, node_mask: Optional[torch.Tensor] = None,
                   device=None) -> torch.Tensor:
    """[num_edges, num_negatives] node ids, uniform over the nodes where
    ``node_mask`` is set (over all ``num_nodes`` without it). Static shapes
    throughout: r = floor(u * n_valid) with u uniform in [0, 1) (float64),
    then the (r + 1)-th valid node, found by ``searchsorted`` in the mask's
    running count."""
    shape = (num_edges, num_negatives)
    if node_mask is None:
        return torch.randint(0, num_nodes, shape, generator=generator, device=device)
    count = torch.cumsum(node_mask.to(torch.int64), 0)
    n_valid = count[-1]
    u = torch.rand(shape, generator=generator, device=count.device, dtype=torch.float64)
    r = torch.minimum(torch.floor(u * n_valid).to(torch.int64), n_valid - 1)
    return torch.searchsorted(count, r + 1)


def skipgram_loss(
    embeddings: torch.Tensor,          # [N, D] pooled node embeddings
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_negatives: int = 5,
    node_mask: Optional[torch.Tensor] = None,
    neg_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GraphSAGE skip-gram loss over the real edges. The negatives are
    ``neg_idx`` [E, Q] when given, else drawn from ``generator``
    (``draw_negatives``): from the valid nodes only when ``node_mask`` is
    given, since a padded graph's pad rows are bias-driven embeddings that
    would skew the contrastive gradient."""
    z = embeddings
    zu, zv = z[senders], z[receivers]
    m = edge_mask.to(z.dtype)
    pos = -F.logsigmoid(torch.sum(zu * zv, dim=-1)) * m
    if neg_idx is None:
        neg_idx = draw_negatives(generator, senders.shape[0], num_negatives, z.shape[0],
                                 node_mask, device=z.device)
    zn = z[neg_idx]                                          # [E, Q, D]
    neg_logit = torch.einsum("ed,eqd->eq", zu, zn)
    neg = -torch.sum(F.logsigmoid(-neg_logit), dim=-1) * m
    return torch.sum(pos + neg) / torch.clamp_min(torch.sum(m), 1.0)


def predictive_masked_feature_loss(
    pooled: torch.Tensor,              # [N, D] pooled embeddings
    x: torch.Tensor,                   # [N, F] raw features
    node_mask: torch.Tensor,
    predictor: Callable[[torch.Tensor], torch.Tensor],   # [N, D] -> [N, F]
) -> torch.Tensor:
    """Binary cross-entropy of feature presence (x != 0) predicted from the
    pooled embedding, averaged over the real nodes' features."""
    logits = predictor(pooled)
    targets = (x != 0).to(logits.dtype)
    per = torch.relu(logits) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    m = node_mask.to(logits.dtype)[:, None]
    return torch.sum(per * m) / torch.clamp_min(torch.sum(m) * x.shape[1], 1.0)


class SSLPretrainer(nn.Module):
    """A backbone (AMPGCN-style: its aux holds 'pooled') under an SSL head;
    its forward returns the loss. mode: 'contrastive' | 'predictive'. In
    'predictive' mode ``feature_predictor`` (flax Dense's init: lecun-normal
    weight, zero bias, drawn from ``generator``, seed 0 when None) maps the
    pooled tokens to the features."""

    def __init__(self, backbone: nn.Module, mode: str = "contrastive",
                 num_negatives: int = 5, num_features: int = 1433,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown SSL mode {mode!r}")
        self.backbone, self.mode = backbone, mode
        self.num_negatives, self.num_features = num_negatives, num_features
        if mode == "predictive":
            self.feature_predictor = nn.Linear(backbone.config.embedding_dim, num_features)
            with torch.no_grad():
                _lecun_normal_(self.feature_predictor,
                               generator or torch.Generator().manual_seed(0))
            self.feature_predictor.to(next(backbone.parameters()).device)

    @property
    def config(self):
        """The backbone's config (what a captured step is keyed on)."""
        return self.backbone.config

    def forward(self, graph: Graph, deterministic: bool = False,
                sampled_idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                edge_layout: Optional[EdgeLayout] = None,
                neg_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The SSL loss (a 0-d tensor). The backbone draws its tokens (unless
        ``sampled_idx``) and, with ``deterministic=False``, its dropout from
        ``generator``; the contrastive negatives come after them from the
        same generator, unless ``neg_idx`` [E, Q] is given."""
        out = self.backbone(graph, deterministic=deterministic, sampled_idx=sampled_idx,
                            generator=generator, edge_layout=edge_layout,
                            return_aux=True, attention_weights=False)
        pooled = out.aux["pooled"]
        if self.mode == "contrastive":
            return skipgram_loss(pooled, graph.senders, graph.receivers, graph.edge_mask,
                                 generator, self.num_negatives, node_mask=graph.node_mask,
                                 neg_idx=neg_idx)
        w = self.feature_predictor.weight
        return predictive_masked_feature_loss(
            pooled.to(torch.promote_types(pooled.dtype, w.dtype)), graph.x,
            graph.node_mask, self.feature_predictor)


def _ssl_step_body(model: SSLPretrainer):
    """The eager step: step(state, graph, layout=None, lr=None,
    sampled_idx=None, neg_idx=None) -> (state, {'loss'}), one optimizer
    step on the SSL loss with dropout on (the JAX step's
    ``deterministic=False``). Every parameter of the state steps, those the
    loss does not reach on a zero gradient (``Optimizer.step``), as under
    optax. ``sampled_idx`` and ``neg_idx`` inject the draws (tests)."""

    def step(state: TrainState, graph: Graph, layout: Optional[EdgeLayout] = None,
             lr: Optional[torch.Tensor] = None, sampled_idx: Optional[torch.Tensor] = None,
             neg_idx: Optional[torch.Tensor] = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.model is not model:
            raise ValueError("the state belongs to another model than this step")
        state.optimizer.zero_grad()
        loss = model(graph, deterministic=False, sampled_idx=sampled_idx,
                     generator=state.generator, edge_layout=layout, neg_idx=neg_idx)
        loss.backward()
        state.optimizer.step(lr)
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


def make_ssl_train_step(model: SSLPretrainer):
    """step(state, graph, layout=None) -> (state, {'loss'}): one SSL
    optimizer step (``_ssl_step_body``); on the card one CUDA-graph replay,
    the tokens, dropout masks and negatives drawn inside the graph from the
    state's generator. On the CPU the eager body."""
    body = _ssl_step_body(model)
    if not _on_card(model):
        return body
    return _captured_train_step(model, body, 1, stacked=False)
