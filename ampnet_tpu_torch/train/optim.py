"""Optimizer and LR schedule (``ampnet_tpu/train/optim.py`` in torch).

The JAX package rebuilds torch's recipe out of optax parts; here it is
torch's own: Adam with L2-style ``weight_decay`` (the decay is added to the
gradient BEFORE the moments, not AdamW) and CosineAnnealingWarmRestarts
stepped once per iteration. Gradient clipping by global norm comes first,
with optax's rule (scale by max_norm / norm only when norm >= max_norm, no
epsilon), so that one step equals the JAX package's.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch


def cosine_warm_restarts(
    optimizer: torch.optim.Optimizer,
    t_0: int,
    t_mult: int = 1,
    eta_min: float = 0.0,
) -> torch.optim.lr_scheduler.CosineAnnealingWarmRestarts:
    """lr(t) = eta_min + (base_lr - eta_min) * (1 + cos(pi * T_cur/T_i)) / 2
    with restart cycles T_0, T_0*t_mult, ...; call ``.step()`` once per
    iteration, after the optimizer's."""
    if t_0 <= 0:
        raise ValueError("t_0 must be positive")
    return torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(
        optimizer, T_0=t_0, T_mult=t_mult, eta_min=eta_min)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """In place: grads *= max_norm / norm when the global L2 norm reaches
    max_norm. The scale stays on the device (no host read)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


class Optimizer:
    """[clip] -> Adam with L2 -> [cosine schedule]: ``step()`` applies the
    parameters' ``.grad`` and advances the schedule."""

    def __init__(self, params: Iterable[torch.nn.Parameter], adam: torch.optim.Adam,
                 scheduler, grad_clip: Optional[float]):
        self.params = list(params)
        self.adam, self.scheduler, self.grad_clip = adam, scheduler, grad_clip

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip is not None:
            clip_by_global_norm([p.grad for p in self.params if p.grad is not None],
                                self.grad_clip)
        self.adam.step()
        if self.scheduler is not None:
            self.scheduler.step()

    @property
    def learning_rate(self) -> float:
        return self.adam.param_groups[0]["lr"]

    def state_dict(self) -> Dict[str, Any]:
        return {"adam": self.adam.state_dict(),
                "scheduler": None if self.scheduler is None else self.scheduler.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adam.load_state_dict(state["adam"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    learning_rate: float,
    weight_decay: float = 0.0,
    cosine_t0: Optional[int] = None,
    cosine_t_mult: int = 2,
    eta_min: float = 0.0,
    grad_clip: Optional[float] = None,
) -> Optimizer:
    """The recipe's chain over ``params``: [clip] -> +wd*p -> Adam moments
    (b1 0.9, b2 0.999, eps 1e-8) -> -lr, lr constant or cosine warm restarts."""
    params = list(params)
    adam = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    scheduler = (cosine_warm_restarts(adam, cosine_t0, cosine_t_mult, eta_min)
                 if cosine_t0 else None)
    return Optimizer(params, adam, scheduler, grad_clip)
