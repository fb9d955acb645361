"""Multi-seed robustness of the headline full-batch recipe
(``experiments/seed_robustness.py`` in the port).

The recipe (tfidf S=40, the dataset-level scaler, best-validation
selection, the 8-draw eval) trained once per seed; mean, std, min and max
of the test accuracy over the seeds, and of the validation accuracy. A
seed draws the model's weights and the training's random streams; the
graph is the same for every seed. The convs run the plain path on the
card (the JAX driver leaves ``use_pallas`` off: its XLA convs).

    python -m ampnet_tpu_torch.experiments.seed_robustness --seeds 1 2 3 \\
        [--raw-residual gcn2] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Sequence

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig, TrainConfig
from ampnet_tpu_torch.experiments.common import cora_graph, release_graphs
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train.loop import train_full_batch


def summary(values) -> Dict[str, float]:
    """mean, std (population, as numpy's), min and max of ``values``."""
    a = np.asarray(values, dtype=np.float64)
    return {"mean": float(a.mean()), "std": float(a.std()), "min": float(a.min()),
            "max": float(a.max())}


def run(epochs: int = 300, lr: float = 3e-3, seeds: Sequence[int] = (1, 2, 3),
        raw_residual: str = "", dropout: float = 0.1, dropout_adj: float = 0.0,
        weight_decay: float = 5e-4, transformer_block: bool = False,
        device="cuda") -> Dict[str, Any]:
    """Train the recipe at each seed; returns the rows (seed, val, test,
    seconds) and the summaries of test and val accuracy."""
    d, full_g = cora_graph()
    scaler_stats = fit_scaler(d.x)
    cfg = AMPGCNConfig(
        num_sampled_vectors=40, token_sampling="tfidf", scaler="precomputed",
        dropout_rate=dropout, dropout_adj_rate=dropout_adj,
        transformer_block=transformer_block,
        raw_residual=raw_residual or False,
    )
    rows = []
    for seed in seeds:
        release_graphs()
        t0 = time.time()
        model = AMPGCN(cfg, scaler_stats=scaler_stats,
                       generator=torch.Generator().manual_seed(seed), device=device)
        tcfg = TrainConfig(
            learning_rate=lr, weight_decay=weight_decay,
            epochs=epochs, cosine_t0=None, grad_clip=1.0,
            select_best_every=10, num_eval_samples=8, checkpoint_every=0,
            seed=seed,
        )
        res = train_full_batch(model, full_g, tcfg, eval_graph=full_g)
        fm = res["final_metrics"]
        rows.append(dict(seed=seed, val_acc=fm.get("val_acc", float("nan")),
                         test_acc=fm.get("test_acc", float("nan")),
                         seconds=time.time() - t0))
        print(f"[{rows[-1]['seconds']:6.1f}s] seed {seed}: "
              f"val {rows[-1]['val_acc']:.4f} test {rows[-1]['test_acc']:.4f}", flush=True)
    out = {"rows": rows, "test": summary([r["test_acc"] for r in rows]),
           "val": summary([r["val_acc"] for r in rows])}
    print(f"\n=== {len(rows)} seeds (raw_residual={raw_residual}, "
          f"tblock={transformer_block}) ===")
    t, v = out["test"], out["val"]
    print(f"test: mean {t['mean']:.4f} std {t['std']:.4f} "
          f"min {t['min']:.4f} max {t['max']:.4f}")
    print(f"val:  mean {v['mean']:.4f} std {v['std']:.4f}")
    return out


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--raw-residual", type=str, default="",
                    help="'' (off) | mlp | gcn | gcn2")
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--dropout-adj", type=float, default=0.0)
    ap.add_argument("--weight-decay", type=float, default=5e-4)
    ap.add_argument("--transformer-block", action="store_true",
                    help="pre-LN transformer stack (composes with raw_residual=gcn2)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return run(a.epochs, a.lr, a.seeds, a.raw_residual, a.dropout, a.dropout_adj,
               a.weight_decay, a.transformer_block, a.device)


if __name__ == "__main__":
    main()
