"""Evaluation step (``make_eval_step`` of ``ampnet_tpu/train/state.py``).

The deterministic forward (no dropout) that produces every accuracy the
recipes report. Token sampling still draws (the reference samples at eval
too); ``num_eval_samples`` > 1 averages log-probs over that many draws.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.ops.hopper.format import EdgeLayout
from ampnet_tpu_torch.train.losses import masked_accuracy, masked_mean_nll


def make_eval_step(
    model: torch.nn.Module,
    num_eval_samples: int = 1,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """step(graph, generator, layout=None) -> {'<split>_acc', '<split>_loss'}
    for each of train/val/test whose mask the graph has. The draws come in
    order from ``generator`` (on the graph's device)."""

    @torch.no_grad()
    def step(graph: Graph, generator: torch.Generator,
             layout: Optional[EdgeLayout] = None) -> Dict[str, torch.Tensor]:
        logits = model(graph, generator=generator, edge_layout=layout)
        for _ in range(num_eval_samples - 1):
            logits = logits + model(graph, generator=generator, edge_layout=layout)
        logits = logits / num_eval_samples
        metrics = {}
        for name, mask in (("train", graph.train_mask), ("val", graph.val_mask),
                           ("test", graph.test_mask)):
            if mask is not None:
                m = mask & graph.node_mask
                metrics[f"{name}_acc"] = masked_accuracy(logits, graph.y, m)
                metrics[f"{name}_loss"] = masked_mean_nll(logits, graph.y, m)
        return metrics

    return step
