"""Full-batch training loop (``train_full_batch`` of
``ampnet_tpu/train/loop.py``): the recommended recipe's protocol — masked
mean NLL, best-validation selection every ``select_best_every`` epochs with
the ``num_eval_samples``-draw ensemble eval, periodic checkpoints and
resume, final metrics from the selected parameters.

The loop runs where the model lives (the card unless the caller built the
model on the CPU); the graph is moved there.
"""
from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List, Optional

import torch

from ampnet_tpu_torch.core.config import TrainConfig
from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.ops.hopper.format import compute_layout
from ampnet_tpu_torch.train.checkpoint import (
    clone_params,
    restore_best,
    resume_or_create,
    save_checkpoint,
)
from ampnet_tpu_torch.train.optim import make_optimizer
from ampnet_tpu_torch.train.rundir import Logfile
from ampnet_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_eval_step,
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


def _use_pallas(model: torch.nn.Module) -> bool:
    return bool(getattr(getattr(model, "config", None), "use_pallas", False))


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
    if cfg.profile_steps:
        raise NotImplementedError("profile_steps: the profiler capture is not ported yet")
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
    best_val, best_params = -1.0, None
    if cfg.run_dir and start_epoch:
        best_val, best_params = restore_best(cfg.run_dir)
        if best_params is not None:
            best_params = {k: v.to(device) for k, v in best_params.items()}
            log.log(f"restored banked best (val acc {best_val:.4f})")

    # k eager steps per chunk, their metrics read back from the device once
    # per chunk: the same math as k single steps. Chunks start k-aligned so
    # that no cadence boundary falls inside one; single steps close the gap.
    k = dispatch_chunk(cfg)
    t0 = time.time()
    epoch = start_epoch
    while epoch < cfg.epochs:
        steps = k if (epoch % k == 0 and epoch + k <= cfg.epochs) else 1
        pending = []
        for _ in range(steps):
            state, metrics = train_step(state, graph, layout)
            pending.append(metrics)
        rows = [{kk: float(v) for kk, v in m.items()} for m in pending]
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

    last_params = clone_params(model)
    final_params = best_params if best_params is not None else last_params
    if best_params is not None:
        log.log(f"model selection: best val acc {best_val:.4f}")
        model.load_state_dict(best_params)
    try:
        final = evaluate(cfg.seed + 999)
    finally:
        if best_params is not None:
            model.load_state_dict(last_params)
    headline = final.get("test_acc", final.get("train_acc", float("nan")))
    log.log(f"Final Test Accuracy: {headline:.4f} ({time.time() - t0:.1f}s)")
    if cfg.run_dir:
        save_checkpoint(os.path.join(cfg.run_dir, "checkpoint_final.pkl"),
                        state, cfg.epochs - 1, history[-1]["loss"] if history else None)
    return {"state": state, "history": history, "final_metrics": final,
            "final_params": final_params}
