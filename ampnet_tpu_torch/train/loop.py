"""Training loops (``ampnet_tpu/train/loop.py`` in torch): full-batch and
GraphSAINT-subgraph.

* ``train_full_batch``: the recommended recipe's protocol — masked mean
  NLL, best-validation selection every ``select_best_every`` epochs with the
  ``num_eval_samples``-draw ensemble eval, periodic checkpoints and resume,
  final metrics from the selected parameters.
* ``train_saint``: one optimizer step per sampled subgraph, ``num_steps``
  subgraphs per epoch, the LR schedule advancing per step, a node_norm-
  weighted loss, the same selection / checkpoint / resume protocol with a
  full-graph eval.

The loops run where the model lives (the card unless the caller built the
model on the CPU); graphs and layouts are moved there. On the card every
step is a CUDA-graph replay (``train/state.py``): ``epochs_per_dispatch``
k-step graphs in ``train_full_batch``, one graph per GraphSAINT budget in
``train_saint`` (its subgraphs' layouts padded to a fixed capacity), and
one per eval graph holding all of its draws. ``profile_steps`` traces
that many steps after the first (the capture) into
``<run_dir>/profile/trace.json``.
"""
from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List, Optional

import torch

from ampnet_tpu_torch.core.config import TrainConfig
from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler
from ampnet_tpu_torch.ops.hopper.format import (
    DEFAULT_TILE_NODES,
    compute_layout,
    default_edge_budget,
    required_edge_budget,
)
from ampnet_tpu_torch.train.checkpoint import (
    clone_params,
    restore_best,
    resume_or_create,
    save_checkpoint,
)
from ampnet_tpu_torch.train.optim import make_optimizer
from ampnet_tpu_torch.train.profiling import StepTraceCapture
from ampnet_tpu_torch.train.rundir import Logfile
from ampnet_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_scan_train_step,
    make_train_step,
)


def _opt(cfg: TrainConfig, model: torch.nn.Module):
    return make_optimizer(
        model.parameters(),
        learning_rate=cfg.learning_rate,
        weight_decay=cfg.weight_decay,
        cosine_t0=cfg.cosine_t0,
        cosine_t_mult=cfg.cosine_t_mult,
        eta_min=cfg.eta_min,
        grad_clip=cfg.grad_clip,
    )


def _tracer(cfg: TrainConfig, log: Logfile) -> Optional[StepTraceCapture]:
    """cfg.profile_steps > 0: a bounded torch.profiler capture under run_dir."""
    if not (cfg.profile_steps and cfg.run_dir):
        return None
    pdir = os.path.join(cfg.run_dir, "profile")
    log.log(f"profiling {cfg.profile_steps} steps (after the capture) -> {pdir}")
    return StepTraceCapture(pdir, cfg.profile_steps)


def _use_pallas(model: torch.nn.Module) -> bool:
    return bool(getattr(getattr(model, "config", None), "use_pallas", False))


def _saint_layout_budget(sampler: GraphSaintRandomWalkSampler,
                         tile_nodes: int = DEFAULT_TILE_NODES) -> int:
    """The per-tile edge budget all subgraphs of a sampler share: twice the
    average edges per tile at its pad sizes, plus 128."""
    num_tiles = -(-sampler.pad_nodes_to // tile_nodes)
    return default_edge_budget(sampler.pad_edges_to, num_tiles)


def _restore_banked_best(cfg: TrainConfig, start_epoch: int, device, log: Logfile):
    """(best_val, best_params) of a resumed run's checkpoint_best.pkl, so
    that a worse validation after the resume cannot overwrite it."""
    best_val, best_params = -1.0, None
    if cfg.run_dir and start_epoch:
        best_val, best_params = restore_best(cfg.run_dir)
        if best_params is not None:
            best_params = {k: v.to(device) for k, v in best_params.items()}
            log.log(f"restored banked best (val acc {best_val:.4f})")
    return best_val, best_params


def _final_eval(model, evaluate, cfg: TrainConfig, best_val, best_params, log: Logfile):
    """(final metrics, final_params): the eval of the selected parameters
    when there are any, else of the last ones; the model keeps the last."""
    last_params = clone_params(model)
    if best_params is None:
        return evaluate(cfg.seed + 999), last_params
    log.log(f"model selection: best val acc {best_val:.4f}")
    model.load_state_dict(best_params)
    try:
        return evaluate(cfg.seed + 999), best_params
    finally:
        model.load_state_dict(last_params)


def dispatch_chunk(cfg: TrainConfig) -> int:
    """cfg.epochs_per_dispatch clipped (gcd) to divide the eval and the
    checkpoint cadence, so those actions land exactly on their epochs."""
    k = max(1, int(cfg.epochs_per_dispatch))
    for cadence in (cfg.select_best_every,
                    cfg.checkpoint_every if cfg.run_dir else 0):
        if cadence:
            k = math.gcd(k, cadence)
    return k


def train_full_batch(
    model: torch.nn.Module,
    graph: Graph,
    cfg: TrainConfig,
    eval_graph: Optional[Graph] = None,
    log: Optional[Logfile] = None,
    state: Optional[TrainState] = None,
) -> Dict[str, Any]:
    """Whole-graph training (cora_benchmark_full.py pattern).

    Returns {'state', 'history', 'final_metrics', 'final_params'}: the model
    inside ``state`` keeps the LAST epoch's parameters; ``final_params`` is
    a state_dict of the best-validation parameters when ``select_best_every``
    is on (what ``final_metrics`` was computed from), else of the last ones.
    """
    log = log or Logfile()
    device = next(model.parameters()).device
    graph = graph.to(device)
    eval_graph = graph if eval_graph is None else eval_graph.to(device)
    start_epoch = 0
    if state is None:
        state = create_train_state(model, _opt(cfg, model), seed=cfg.seed)
        state, start_epoch = resume_or_create(cfg.run_dir, state)
        if start_epoch:
            log.log(f"resumed from epoch {start_epoch - 1}")
    train_step = make_train_step(model, loss_mode="full")
    eval_step = make_eval_step(model, num_eval_samples=cfg.num_eval_samples)

    # cfg.use_pallas honored automatically: the layout is built on the host
    # once per (static) graph
    layout = eval_layout = None
    if _use_pallas(model):
        layout = compute_layout(graph)
        eval_layout = layout if eval_graph is graph else compute_layout(eval_graph)

    def evaluate(seed: int) -> Dict[str, float]:
        gen = torch.Generator(device=device).manual_seed(seed)
        return {k: float(v) for k, v in eval_step(eval_graph, gen, eval_layout).items()}

    history: List[Dict[str, float]] = []
    best_val, best_params = _restore_banked_best(cfg, start_epoch, device, log)
    tracer = _tracer(cfg, log)

    # k steps per dispatch (make_scan_train_step: one CUDA graph on the card),
    # their metrics read back once: the same math as k single steps. Chunks
    # start k-aligned so that no cadence boundary falls inside one; single
    # steps close the gap. Per-step profiling keeps k = 1.
    k = 1 if tracer is not None else dispatch_chunk(cfg)
    scan_step = (make_scan_train_step(model, loss_mode="full", num_steps=k)
                 if k > 1 else None)
    t0 = time.time()
    epoch = start_epoch
    while epoch < cfg.epochs:
        if scan_step is not None and epoch % k == 0 and epoch + k <= cfg.epochs:
            state, stacked = scan_step(state, graph, layout)
            stacked = {kk: v.tolist() for kk, v in stacked.items()}
            rows = [{kk: v[j] for kk, v in stacked.items()} for j in range(k)]
        else:
            if tracer:
                tracer.before_step()
            state, metrics = train_step(state, graph, layout)
            if tracer:
                tracer.after_step(block_on=metrics)
            rows = [{kk: float(v) for kk, v in metrics.items()}]
        for j, row in enumerate(rows):
            row["epoch"] = epoch + j
            history.append(row)
            if (epoch + j) % cfg.log_every == 0:
                log.log(
                    f"Epoch {epoch + j:4d} | loss {row['loss']:.4f} | "
                    f"train acc {row.get('train_acc', float('nan')):.4f} | "
                    f"test acc {row.get('test_acc', float('nan')):.4f}"
                )
        epoch += len(rows)
        if (cfg.select_best_every and eval_graph.val_mask is not None
                and epoch % cfg.select_best_every == 0):
            va = evaluate(cfg.seed + 7).get("val_acc", -1.0)
            if va > best_val:
                best_val, best_params = va, clone_params(model)
                if cfg.run_dir:
                    save_checkpoint(
                        os.path.join(cfg.run_dir, "checkpoint_best.pkl"),
                        state, epoch - 1, None, extra={"best_val_acc": best_val},
                        params=best_params)
        if cfg.run_dir and cfg.checkpoint_every and epoch % cfg.checkpoint_every == 0:
            save_checkpoint(
                os.path.join(cfg.run_dir, f"checkpoint_ep{epoch - 1}.pkl"),
                state, epoch - 1, rows[-1]["loss"])
    if tracer:
        tracer.close()

    final, final_params = _final_eval(model, evaluate, cfg, best_val, best_params, log)
    headline = final.get("test_acc", final.get("train_acc", float("nan")))
    log.log(f"Final Test Accuracy: {headline:.4f} ({time.time() - t0:.1f}s)")
    if cfg.run_dir:
        save_checkpoint(os.path.join(cfg.run_dir, "checkpoint_final.pkl"),
                        state, cfg.epochs - 1, history[-1]["loss"] if history else None)
    return {"state": state, "history": history, "final_metrics": final,
            "final_params": final_params}


def train_saint(
    model: torch.nn.Module,
    sampler: GraphSaintRandomWalkSampler,
    full_graph: Graph,
    cfg: TrainConfig,
    log: Optional[Logfile] = None,
    state: Optional[TrainState] = None,
    prefetch: bool = True,
) -> Dict[str, Any]:
    """GraphSAINT subgraph training (cora_benchmark_graphsaint.py pattern).

    One optimizer step per sampled subgraph; ``len(sampler)`` subgraphs per
    epoch; the LR schedule advances per step. Model selection and the final
    accuracy use a full-graph forward. Returns {'state', 'history' (the last
    step's row of each epoch), 'final_metrics', 'final_params'} as
    ``train_full_batch`` does."""
    log = log or Logfile()
    device = next(model.parameters()).device
    full_graph = full_graph.to(device)
    start_epoch = 0
    if state is None:
        state = create_train_state(model, _opt(cfg, model), seed=cfg.seed)
        state, start_epoch = resume_or_create(cfg.run_dir, state)
        if start_epoch:
            log.log(f"resumed from epoch {start_epoch - 1}")
    train_step = make_train_step(
        model, loss_mode="saint_mean" if cfg.saint_loss == "mean" else "saint")
    eval_step = make_eval_step(model, num_eval_samples=cfg.num_eval_samples)

    # cfg.use_pallas: one fixed per-tile edge budget across subgraphs, their
    # slots padded to its capacity, so that all steps see the same layout
    # shapes (one captured graph); a tail-large subgraph bumps the budget,
    # mirroring the sampler's pad regrow (a new capture, as JAX retraces)
    use_pallas = _use_pallas(model)
    full_layout = compute_layout(full_graph) if use_pallas else None
    budget = _saint_layout_budget(sampler) if use_pallas else 0

    def sub_layout(sub: Graph):
        nonlocal budget
        if not use_pallas:
            return None
        try:
            return compute_layout(sub, edges_per_tile=budget)
        except ValueError:
            budget = max(budget, _saint_layout_budget(sampler), required_edge_budget(sub))
            log.log(f"edge-layout budget regrown to {budget}")
            return compute_layout(sub, edges_per_tile=budget)

    def evaluate(seed: int) -> Dict[str, float]:
        gen = torch.Generator(device=device).manual_seed(seed)
        return {k: float(v) for k, v in eval_step(full_graph, gen, full_layout).items()}

    history: List[Dict[str, float]] = []
    best_val, best_params = _restore_banked_best(cfg, start_epoch, device, log)
    tracer = _tracer(cfg, log)
    t0 = time.time()
    for epoch in range(start_epoch, cfg.epochs):
        it = sampler.prefetch() if prefetch else iter(sampler)
        for i, sub in enumerate(it):
            # the layout is built on the host from the host graph; both then
            # move to the model's device
            layout = sub_layout(sub)
            lr = state.optimizer.learning_rate       # the one this step applies
            if tracer:
                tracer.before_step()
            state, metrics = train_step(
                state, sub.to(device), None if layout is None else layout.to(device))
            if tracer:
                tracer.after_step(block_on=metrics)
            last = i == len(sampler) - 1
            if last or (cfg.log_every_steps and i % cfg.log_every_steps == 0):
                row = {k: float(v) for k, v in metrics.items()}
                row["epoch"] = epoch
                row["lr"] = lr
                log.log(
                    f"Epoch: {epoch:03d}, Partition: {i:03d}, "
                    f"LR: {row['lr']:.6f}, Train loss: {row['loss']:.4f}, "
                    f"Train acc: {row.get('train_acc', float('nan')):.4f}"
                )
                if last:
                    history.append(row)
        if (cfg.select_best_every and full_graph.val_mask is not None
                and (epoch + 1) % cfg.select_best_every == 0):
            va = evaluate(cfg.seed + 7).get("val_acc", -1.0)
            if va > best_val:
                best_val, best_params = va, clone_params(model)
                if cfg.run_dir:
                    # a crash after epoch K must not lose the best model so far
                    save_checkpoint(
                        os.path.join(cfg.run_dir, "checkpoint_best.pkl"),
                        state, epoch, None, extra={"best_val_acc": best_val},
                        params=best_params)
            log.log(f"Eval epoch {epoch:4d} | val acc {va:.4f} | best {best_val:.4f}")
        if cfg.run_dir and cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0:
            save_checkpoint(
                os.path.join(cfg.run_dir, f"checkpoint_ep{epoch}.pkl"),
                state, epoch, history[-1]["loss"] if history else None)
    if tracer:
        tracer.close()

    final, final_params = _final_eval(model, evaluate, cfg, best_val, best_params, log)
    log.log(f"Final Test Accuracy: {final.get('test_acc', float('nan')):.4f} "
            f"({time.time() - t0:.1f}s)")
    if cfg.run_dir:
        save_checkpoint(os.path.join(cfg.run_dir, "checkpoint_final.pkl"),
                        state, cfg.epochs - 1, history[-1]["loss"] if history else None)
    return {"state": state, "history": history, "final_metrics": final,
            "final_params": final_params}
