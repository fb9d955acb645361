"""LR-schedule probe (``experiments/cosine_lr_scheduler_test.py`` in the
port): CosineAnnealingWarmRestarts(T_0=150, T_mult=2)'s rate every 10
iterations, from the port's ``cosine_warm_restarts``. Host only.

    python -m ampnet_tpu_torch.experiments.cosine_lr_scheduler_test
"""
from __future__ import annotations

from typing import List, Tuple

from ampnet_tpu_torch.train.optim import cosine_warm_restarts


def main(iters: int = 700, base_lr: float = 0.1, t0: int = 150,
         t_mult: int = 2) -> List[Tuple[int, float]]:
    """Print and return (iteration, rate) every 10 iterations."""
    sched = cosine_warm_restarts(base_lr, t0, t_mult)
    rows = [(i, float(sched(i))) for i in range(0, iters, 10)]
    for i, lr in rows:
        print(f"iter {i:5d}  lr {lr:.6f}")
    return rows


if __name__ == "__main__":
    main()
