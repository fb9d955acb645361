"""Train state and step builders (``ampnet_tpu/train/state.py`` in torch).

The training step runs the model with dropout and edge dropout on, takes
the masked mean NLL (or a GraphSAINT node_norm-weighted loss), and lets ``loss.backward()`` go through the fused
op's backward kernels. The eval step is the deterministic forward (no
dropout) that produces every accuracy the recipes report. Token sampling
draws in both (the reference samples at eval too); ``num_eval_samples`` > 1
averages log-probs over that many draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.ops.hopper.format import EdgeLayout
from ampnet_tpu_torch.train.losses import (
    masked_accuracy,
    masked_mean_nll,
    saint_weighted_mean_nll,
    saint_weighted_nll,
)
from ampnet_tpu_torch.train.optim import Optimizer


@dataclass
class TrainState:
    """What a training run carries from step to step. Unlike the JAX
    package's immutable state, a step updates it IN PLACE: the model's
    parameters, the optimizer's moments, the generator and the count."""

    model: torch.nn.Module
    optimizer: Optimizer
    generator: torch.Generator     # token sampling, dropout, edge dropout
    step: int = 0


def create_train_state(model: torch.nn.Module, optimizer: Optimizer,
                       seed: int = 0) -> TrainState:
    """The model is already initialized (from its own generator); ``seed``
    seeds the training noise, drawn on the model's device."""
    device = next(model.parameters()).device
    return TrainState(model, optimizer,
                      torch.Generator(device=device).manual_seed(seed))


LOSS_MODES = ("full", "saint", "saint_mean")


def training_loss(loss_mode: str, logits: torch.Tensor, graph: Graph) -> torch.Tensor:
    """'full': masked mean NLL; 'saint': node_norm-weighted NLL sum;
    'saint_mean': node_norm-weighted NLL mean (the stabilized recipe); all
    over the graph's real training nodes."""
    train = graph.train_mask & graph.node_mask
    if loss_mode == "saint":
        return saint_weighted_nll(logits, graph.y, graph.node_norm, train)
    if loss_mode == "saint_mean":
        return saint_weighted_mean_nll(logits, graph.y, graph.node_norm, train)
    return masked_mean_nll(logits, graph.y, train)


def make_train_step(
    model: torch.nn.Module,
    loss_mode: str = "full",
    forward: Optional[Callable[..., torch.Tensor]] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """step(state, graph, layout=None) -> (state, metrics): one optimizer
    step on the loss ``loss_mode`` names (``training_loss``). Metrics are 0-d
    tensors left on the device (``loss``, ``train_acc``, and ``test_acc``
    when the graph has a test mask), taken from the training forward.
    ``forward(graph, layout, generator)`` replaces the model call (the
    fused-closure step of ``train/pallas_step.py``)."""
    if loss_mode not in LOSS_MODES:
        raise ValueError(f"unknown loss_mode {loss_mode!r}: one of {LOSS_MODES}")
    if forward is None:
        def forward(graph, layout, generator):
            return model(graph, deterministic=False, generator=generator,
                         edge_layout=layout)

    def step(state: TrainState, graph: Graph,
             layout: Optional[EdgeLayout] = None):
        if state.model is not model:
            raise ValueError("the state belongs to another model than this step")
        state.optimizer.zero_grad()
        logits = forward(graph, layout, state.generator)
        loss = training_loss(loss_mode, logits, graph)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            train = graph.train_mask & graph.node_mask
            metrics = {"loss": loss.detach(),
                       "train_acc": masked_accuracy(logits, graph.y, train)}
            if graph.test_mask is not None:
                metrics["test_acc"] = masked_accuracy(
                    logits, graph.y, graph.test_mask & graph.node_mask)
        return state, metrics

    return step


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
