"""Optimizer and LR schedule (``ampnet_tpu/train/optim.py`` in torch).

The JAX package rebuilds torch's recipe out of optax parts; here it is
torch's own: Adam with L2-style ``weight_decay`` (the decay is added to the
gradient BEFORE the moments, not AdamW) and CosineAnnealingWarmRestarts'
rates, one per iteration. Gradient clipping by global norm comes first,
with optax's rule (scale by max_norm / norm only when norm >= max_norm, no
epsilon), so that one step equals the JAX package's.

On the card Adam is capturable: its step count, moments and learning rate
are device tensors made before the first step, so that a captured CUDA
graph (``train/graphs.py``) holds them. The host computes each step's rate
(``Optimizer.rate``); an eager step writes it into the learning-rate
tensor, a captured one copies it from a table the caller fills before the
replay. On the CPU the optimizer is torch's default Adam with a float rate.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch


def cosine_warm_restarts(
    base_lr: float,
    t_0: int,
    t_mult: int = 1,
    eta_min: float = 0.0,
) -> Callable[[int], float]:
    """torch's CosineAnnealingWarmRestarts as a schedule over the iteration
    count (the JAX package's ``cosine_warm_restarts``, on the host):
    lr(t) = eta_min + (base_lr - eta_min) * (1 + cos(pi * T_cur/T_i)) / 2
    with restart cycles T_0, T_0*t_mult, ...; the scheduler's own integer
    walk through the cycles and its formula, so the same floats."""
    if t_0 <= 0:
        raise ValueError("t_0 must be positive")

    def schedule(step: int) -> float:
        t_i, t_cur = t_0, step
        if t_mult == 1:
            t_cur = step % t_0
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= t_mult
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2

    return schedule


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """In place: grads *= max_norm / norm when the global L2 norm reaches
    max_norm. The scale stays on the device (no host read)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


class Optimizer:
    """[clip] -> Adam with L2 -> the rate of step ``count`` (constant, or
    cosine warm restarts): ``step()`` applies the parameters' ``.grad``.
    ``version`` changes whenever the optimizer's tensors are replaced
    (``load_state_dict``): a graph captured over the old ones is stale."""

    def __init__(self, params: Iterable[torch.nn.Parameter], adam: torch.optim.Adam,
                 grad_clip: Optional[float], base_lr: float,
                 schedule: Optional[Callable[[int], float]] = None):
        self.params = list(params)
        self.adam, self.grad_clip = adam, grad_clip
        self.base_lr, self.schedule = base_lr, schedule
        self.count = 0            # optimizer steps taken
        self.version = 0
        if self.capturable:
            self._init_state()

    @property
    def capturable(self) -> bool:
        return bool(self.adam.param_groups[0]["capturable"])

    def _init_state(self) -> None:
        """Adam's state as its first step would make it (moments 0, step
        count 0 on the device), made now, outside any capture; a frozen
        parameter gets none."""
        scalar = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
        for p in self.params:
            if not p.requires_grad:
                continue
            st = self.adam.state[p]
            if not st:
                st["step"] = torch.zeros((), dtype=scalar, device=p.device)
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    def rate(self, step: int) -> float:
        """The learning rate of optimizer step ``step`` (0-based), on the host."""
        return self.base_lr if self.schedule is None else self.schedule(step)

    def rates(self, k: int) -> List[float]:
        """The rates of the next ``k`` steps (a k-step graph's table)."""
        return [self.rate(self.count + i) for i in range(k)]

    @property
    def learning_rate(self) -> float:
        """The rate the next step applies (a host value: no device read)."""
        return self.rate(self.count)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a step writes besides the parameters: Adam's moments
        and step counts and, on the card, the learning-rate tensor."""
        out = [t for st in self.adam.state.values() for t in st.values()
               if isinstance(t, torch.Tensor)]
        if self.capturable:
            out.append(self.adam.param_groups[0]["lr"])
        return out

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self, lr: Optional[torch.Tensor] = None) -> None:
        """One step at ``self.learning_rate``; on the card ``lr`` (a device
        scalar, the entry of a captured step's rate table) takes its place.
        A trainable parameter the loss did not reach (an SSL loss leaves
        the classifier head out) steps on a zero gradient, as optax sees
        it: its L2 term still moves it, and Adam's moments and count
        advance as every other parameter's. A frozen parameter
        (``requires_grad=False``) keeps no gradient and does not move."""
        for p in self.params:
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
        if self.grad_clip is not None:
            clip_by_global_norm([p.grad for p in self.params if p.grad is not None],
                                self.grad_clip)
        group = self.adam.param_groups[0]
        if self.capturable:
            if lr is None:
                group["lr"].fill_(self.learning_rate)
            else:
                group["lr"].copy_(lr)
        else:
            group["lr"] = self.learning_rate
        self.adam.step()
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        capturable, lr = self.capturable, self.adam.param_groups[0]["lr"]
        self.adam.load_state_dict(state["adam"])
        group = self.adam.param_groups[0]
        group["capturable"] = capturable     # as made, whatever device saved it
        if capturable:
            # the device learning-rate tensor stays (the saved one is a copy),
            # and each step count lives beside its parameter
            group["lr"] = lr
            for p in self.params:
                st = self.adam.state[p]
                if "step" not in st:    # frozen: never stepped
                    continue
                st["step"] = torch.as_tensor(st["step"], device=p.device,
                                             dtype=lr.dtype).reshape(())
        if "count" in state:
            self.count = int(state["count"])
        else:   # saved before the count was (with a torch scheduler): Adam's own
            steps = [st["step"] for st in self.adam.state.values() if "step" in st]
            self.count = int(steps[0]) if steps else 0
        self.version += 1


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
    (b1 0.9, b2 0.999, eps 1e-8) -> -lr, lr constant or cosine warm restarts.
    Parameters on the card get the capturable Adam."""
    params = list(params)
    schedule = (cosine_warm_restarts(learning_rate, cosine_t0, cosine_t_mult, eta_min)
                if cosine_t0 else None)
    on_card = params[0].is_cuda
    lr = torch.tensor(learning_rate, device=params[0].device) if on_card else learning_rate
    adam = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, capturable=on_card)
    # the eager steps on the card are meant (tests, and the comparison with
    # the captured ones): torch's one-time warning about them is not
    adam._warned_capturable_if_run_uncaptured = True
    return Optimizer(params, adam, grad_clip, learning_rate, schedule)
