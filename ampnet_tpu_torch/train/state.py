"""Train state and step builders (``ampnet_tpu/train/state.py`` in torch).

The training step runs the model with dropout and edge dropout on, takes
the masked mean NLL (or a GraphSAINT node_norm-weighted loss), and lets
``loss.backward()`` go through the fused op's backward kernels. The eval
step is the deterministic forward (no dropout) that produces every
accuracy the recipes report. Token sampling draws in both (the reference
samples at eval too); ``num_eval_samples`` > 1 averages log-probs over that
many draws.

``_train_step_body`` and ``_eval_step_body`` are the eager steps (the JAX
package's un-jitted bodies). On the card the builders capture them as CUDA
graphs (``train/graphs.py``): ``make_train_step`` one graph per step,
``make_scan_train_step`` one per k steps, ``make_eval_step`` one holding all
of its draws, each replayed with one host call, as ``jax.jit`` and
``lax.scan`` make one dispatch of them in the JAX package. A step's
``graphs`` (a ``graphs.GraphCache``) holds its graphs and what each
capture cost (``timings()``). On the CPU the
builders return the eager bodies. The card's eager bodies serve the tests
and the comparison of captured against eager steps only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.train import graphs
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


def _train_step_body(
    model: torch.nn.Module,
    loss_mode: str = "full",
    forward: Optional[Callable[..., torch.Tensor]] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The eager step: step(state, graph, layout=None, lr=None) -> (state,
    metrics), one optimizer step on the loss ``loss_mode`` names
    (``training_loss``). Metrics are 0-d tensors left on the device
    (``loss``, ``train_acc``, and ``test_acc`` when the graph has a test
    mask), taken from the training forward. ``forward(graph, layout,
    generator)`` replaces the model call (the fused-closure step of
    ``train/pallas_step.py``). ``lr``: a device scalar that replaces the
    optimizer's host rate (a captured step's rate table)."""
    if loss_mode not in LOSS_MODES:
        raise ValueError(f"unknown loss_mode {loss_mode!r}: one of {LOSS_MODES}")
    if forward is None:
        def forward(graph, layout, generator):
            return model(graph, deterministic=False, generator=generator,
                         edge_layout=layout)

    def step(state: TrainState, graph: Graph,
             layout: Optional[EdgeLayout] = None, lr: Optional[torch.Tensor] = None):
        if state.model is not model:
            raise ValueError("the state belongs to another model than this step")
        state.optimizer.zero_grad()
        logits = forward(graph, layout, state.generator)
        loss = training_loss(loss_mode, logits, graph)
        loss.backward()
        state.optimizer.step(lr)
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


def _on_card(model: torch.nn.Module) -> bool:
    return next(model.parameters()).is_cuda


def _captured_train_step(model, body, num_steps: int, stacked: bool):
    """``num_steps`` calls of ``body`` as one CUDA graph per (graph and
    layout shapes, dispatch flags, optimizer, config): each step i takes
    its rate from entry i of a device table the host fills before a replay
    whose rates changed. Metrics come back cloned, stacked [num_steps] when
    ``stacked``."""
    cache = graphs.GraphCache()
    device = next(model.parameters()).device

    def capture(state: TrainState, graph: Graph, layout):
        opt = state.optimizer
        table = torch.zeros(num_steps, dtype=torch.float32, device=device)
        own = TrainState(model, opt, torch.Generator(device=device), state.step)
        own.generator.set_state(state.generator.get_state())

        def run(g, lay):
            rows = [body(own, g, lay, lr=table[i])[1] for i in range(num_steps)]
            if not stacked:
                return rows[0]
            return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

        count = opt.count
        try:
            entry = graphs.Captured(
                run, (graph, layout), writes=[*model.parameters(), *opt.tensors()],
                generator=own.generator,
                warmup=lambda g, lay: body(own, g, lay, lr=table[0]),
                what=f"{num_steps} training step(s) of {type(model).__name__}")
        finally:
            opt.count = count
        # the entry keeps the optimizer alive: its id in the key is not reused
        entry.table, entry.rates, entry.optimizer = table, None, opt
        return entry

    def step(state: TrainState, graph: Graph, layout: Optional[EdgeLayout] = None):
        if state.model is not model:
            raise ValueError("the state belongs to another model than this step")
        opt = state.optimizer
        key = (graphs.signature((graph, layout)), graphs.dispatch_flags(), id(opt),
               opt.version, model.config)
        entry = cache.get(key, lambda: capture(state, graph, layout))
        rates = opt.rates(num_steps)
        if rates != entry.rates:
            for i, r in enumerate(rates):
                entry.table[i].fill_(r)
            entry.rates = rates
        entry.generator.set_state(state.generator.get_state())
        out = entry.replay((graph, layout))
        state.generator.set_state(entry.generator.get_state())
        state.step += num_steps
        opt.count += num_steps
        return state, {k: v.clone() for k, v in out.items()}

    step.graphs = cache
    return step


def make_train_step(
    model: torch.nn.Module,
    loss_mode: str = "full",
    forward: Optional[Callable[..., torch.Tensor]] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """step(state, graph, layout=None) -> (state, metrics): one optimizer
    step (``_train_step_body``); on the card one CUDA-graph replay."""
    body = _train_step_body(model, loss_mode, forward)
    if not _on_card(model):
        return body
    return _captured_train_step(model, body, 1, stacked=False)


def make_scan_train_step(
    model: torch.nn.Module,
    loss_mode: str = "full",
    num_steps: int = 8,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """step(state, graph, layout=None) -> (state, metrics stacked
    [num_steps]): ``num_steps`` optimizer steps on one (static) graph, equal
    to as many calls of ``make_train_step``'s step; on the card one
    CUDA-graph replay for all of them (JAX: ``lax.scan`` in one ``jit``)."""
    body = _train_step_body(model, loss_mode)
    if _on_card(model):
        return _captured_train_step(model, body, num_steps, stacked=True)

    def multi(state: TrainState, graph: Graph, layout: Optional[EdgeLayout] = None):
        rows = []
        for _ in range(num_steps):
            state, metrics = body(state, graph, layout)
            rows.append(metrics)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return multi


def eval_logits(model: torch.nn.Module, graph: Graph, generator: torch.Generator,
                layout: Optional[EdgeLayout] = None, num_samples: int = 1) -> torch.Tensor:
    """The mean log-probs of ``num_samples`` deterministic forwards, their
    token draws in order from ``generator``."""
    logits = model(graph, generator=generator, edge_layout=layout)
    for _ in range(num_samples - 1):
        logits = logits + model(graph, generator=generator, edge_layout=layout)
    return logits / num_samples


def _eval_step_body(
    model: torch.nn.Module,
    num_eval_samples: int = 1,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The eager eval step: step(graph, generator, layout=None) ->
    {'<split>_acc', '<split>_loss'} for each of train/val/test whose mask
    the graph has. The draws come in order from ``generator`` (on the
    graph's device)."""

    @torch.no_grad()
    def step(graph: Graph, generator: torch.Generator,
             layout: Optional[EdgeLayout] = None) -> Dict[str, torch.Tensor]:
        logits = eval_logits(model, graph, generator, layout, num_eval_samples)
        metrics = {}
        for name, mask in (("train", graph.train_mask), ("val", graph.val_mask),
                           ("test", graph.test_mask)):
            if mask is not None:
                m = mask & graph.node_mask
                metrics[f"{name}_acc"] = masked_accuracy(logits, graph.y, m)
                metrics[f"{name}_loss"] = masked_mean_nll(logits, graph.y, m)
        return metrics

    return step


def make_eval_step(
    model: torch.nn.Module,
    num_eval_samples: int = 1,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """step(graph, generator, layout=None) -> metrics (``_eval_step_body``);
    on the card one CUDA-graph replay holding all ``num_eval_samples``
    draws, which come from ``generator``'s state as the eager body's do, and
    advance it as far."""
    body = _eval_step_body(model, num_eval_samples)
    if not _on_card(model):
        return body
    cache = graphs.GraphCache()
    one_draw = _eval_step_body(model, 1)

    def capture(graph, generator, layout):
        own = torch.Generator(device=generator.device)
        own.set_state(generator.get_state())
        return graphs.Captured(
            lambda g, lay: body(g, own, lay), (graph, layout), generator=own,
            warmup=lambda g, lay: one_draw(g, own, lay),
            what=f"the {num_eval_samples}-draw eval step of {type(model).__name__}")

    def step(graph: Graph, generator: torch.Generator,
             layout: Optional[EdgeLayout] = None) -> Dict[str, torch.Tensor]:
        key = (graphs.signature((graph, layout)), graphs.dispatch_flags(), model.config)
        entry = cache.get(key, lambda: capture(graph, generator, layout))
        entry.generator.set_state(generator.get_state())
        out = entry.replay((graph, layout))
        generator.set_state(entry.generator.get_state())
        return {k: v.clone() for k, v in out.items()}

    step.graphs = cache
    return step
