"""Scale the token-sampling budget S (``experiments/token_scale_tuning.py``
in the port).

The recipe (tfidf, the dataset scaler, best-validation selection, the
8-draw eval) at each S of ``--s`` (default 64) on the plain conv stack
(the JAX driver leaves ``use_pallas`` off). At S=64 the plain path's
attention scores take ~0.7 GB on the padded Cora graph.

    python -m ampnet_tpu_torch.experiments.token_scale_tuning --s 40,64 [--device cpu]
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


def run(epochs: int = 300, s: str = "64", device="cuda") -> List[Dict[str, Any]]:
    """One run per S of ``s`` (comma-separated); returns (S, final
    metrics, seconds) rows."""
    d, full_g = cora_graph()
    scaler_stats = fit_scaler(d.x)
    rows = []
    for n in [int(v) for v in s.split(",")]:
        release_graphs()
        t0 = time.time()
        cfg = AMPGCNConfig(num_sampled_vectors=n, token_sampling="tfidf", scaler="precomputed")
        tcfg = TrainConfig(
            learning_rate=3e-3, weight_decay=5e-4, epochs=epochs,
            cosine_t0=None, grad_clip=1.0, select_best_every=10,
            num_eval_samples=8, checkpoint_every=0,
        )
        model = AMPGCN(cfg, scaler_stats=scaler_stats,
                       generator=torch.Generator().manual_seed(tcfg.seed), device=device)
        res = train_full_batch(model, full_g, tcfg, eval_graph=full_g)
        rows.append(dict(s=n, final_metrics=res["final_metrics"], seconds=time.time() - t0))
        fm = rows[-1]["final_metrics"]
        print(f"[{rows[-1]['seconds']:6.1f}s] S={n}: "
              f"val {fm.get('val_acc', float('nan')):.4f} "
              f"test {fm.get('test_acc', float('nan')):.4f}", flush=True)
    print("\n=== summary ===")
    for row in rows:
        fm = row["final_metrics"]
        print(f"S={row['s']}: val {fm.get('val_acc', float('nan')):.4f} "
              f"test {fm.get('test_acc', float('nan')):.4f}", flush=True)
    return rows


def main(argv=None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--s", type=str, default="64")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return run(a.epochs, a.s, a.device)


if __name__ == "__main__":
    main()
