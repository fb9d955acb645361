"""Tune the pre-LN transformer-block AMPGCN variant
(``experiments/transformer_tuning.py`` in the port).

The transformer stack overfits out of the box; this sweep attacks that
with dropout, weight decay and adjacency dropout, the recipe otherwise
kept (tfidf S=40, best-validation selection, the 8-draw eval). The convs
run the plain path on the card (the JAX driver leaves ``use_pallas``
off).

    python -m ampnet_tpu_torch.experiments.transformer_tuning \\
        [--configs drop0.3_adj0.2_wd1e-3] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List

import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig, TrainConfig
from ampnet_tpu_torch.experiments.common import cora_graph, release_graphs
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train.loop import train_full_batch

CONFIGS = [
    # (name, dropout, dropout_adj, weight_decay)
    ("drop0.3_adj0.2_wd1e-3", 0.3, 0.2, 1e-3),
    ("drop0.5_adj0.3_wd5e-4", 0.5, 0.3, 5e-4),
    ("drop0.3_adj0.1_wd5e-3", 0.3, 0.1, 5e-3),
]


def run(epochs: int = 300, configs: str = "", device="cuda") -> List[Dict[str, Any]]:
    """One run per config named in ``configs`` (comma-separated; all when
    empty); returns (name, final metrics, seconds) rows."""
    d, full_g = cora_graph()
    scaler_stats = fit_scaler(d.x)
    todo = CONFIGS if not configs else [c for c in CONFIGS if c[0] in configs.split(",")]
    rows = []
    for name, drop, dadj, wd in todo:
        release_graphs()
        t0 = time.time()
        cfg = AMPGCNConfig(
            num_sampled_vectors=40, token_sampling="tfidf",
            scaler="precomputed", dropout_rate=drop, dropout_adj_rate=dadj,
            transformer_block=True,
        )
        tcfg = TrainConfig(
            learning_rate=3e-3, weight_decay=wd, epochs=epochs,
            cosine_t0=None, grad_clip=1.0, select_best_every=10,
            num_eval_samples=8, checkpoint_every=0,
        )
        model = AMPGCN(cfg, scaler_stats=scaler_stats,
                       generator=torch.Generator().manual_seed(tcfg.seed), device=device)
        res = train_full_batch(model, full_g, tcfg, eval_graph=full_g)
        rows.append(dict(name=name, final_metrics=res["final_metrics"],
                         seconds=time.time() - t0))
        fm = rows[-1]["final_metrics"]
        print(f"[{rows[-1]['seconds']:6.1f}s] {name}: "
              f"val {fm.get('val_acc', float('nan')):.4f} "
              f"test {fm.get('test_acc', float('nan')):.4f}", flush=True)
    print("\n=== summary ===")
    for row in rows:
        fm = row["final_metrics"]
        print(f"{row['name']}: val {fm.get('val_acc', float('nan')):.4f} "
              f"test {fm.get('test_acc', float('nan')):.4f}", flush=True)
    return rows


def main(argv=None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--configs", type=str, default="")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return run(a.epochs, a.configs, a.device)


if __name__ == "__main__":
    main()
