"""Full-batch Cora training (``experiments/cora_benchmark_full.py`` in the
port): whole-graph forward, masked mean NLL, Adam lr 3e-3 with L2, 150
epochs, final test accuracy.

``--raw-residual`` is the recommended recipe: 40 TF-IDF tokens per node
with the dataset-level scaler, dropout 0.3, the gcn2 raw-residual head, the
fused Hopper kernels, clip 1.0, best-validation selection every 10 epochs
with an 8-draw eval, 10 epochs per captured graph. ``--tuned`` is the same
without the head (dropout 0.1). Without either: the reference's S=20
model on the plain path.

    python -m ampnet_tpu_torch.experiments.cora_benchmark_full --raw-residual
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

from ampnet_tpu_torch.core.config import AMPGCNConfig, TrainConfig
from ampnet_tpu_torch.experiments.common import cora_graph
from ampnet_tpu_torch.interpret.curves import plot_history
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train import Logfile, create_run_dir, train_full_batch


def train(epochs: int = 150, run_base: str = "runs", tuned: bool = False,
          raw_residual: bool = False, profile_steps: int = 0,
          epochs_per_dispatch: int = 0, device="cuda") -> Dict[str, Any]:
    """Train and return ``train_full_batch``'s result, with ``run_dir``."""
    d, g = cora_graph()
    recipe = tuned or raw_residual
    if recipe:
        cfg = AMPGCNConfig(
            num_sampled_vectors=40, token_sampling="tfidf", scaler="precomputed",
            dropout_rate=0.3 if raw_residual else 0.1,
            raw_residual="gcn2" if raw_residual else False,
            use_pallas=True,
        )
        model = AMPGCN(cfg, scaler_stats=fit_scaler(d.x), device=device)
    else:
        cfg = AMPGCNConfig(
            embedding_dim=128, num_heads=4, num_node_features=1433,
            num_sampled_vectors=20, output_dim=7, feat_emb_dim=127, val_emb_dim=1,
        )
        model = AMPGCN(cfg, device=device)
    run_dir = create_run_dir(run_base, details="cora full batch")
    tcfg = TrainConfig(
        learning_rate=3e-3,
        weight_decay=1e-3 if raw_residual else 5e-4, epochs=epochs,
        cosine_t0=None, checkpoint_every=10, run_dir=run_dir, log_every=10,
        grad_clip=1.0 if recipe else None,
        select_best_every=10 if recipe else 0,
        num_eval_samples=8 if recipe else 1,
        profile_steps=profile_steps,
        # the recipe: 10 epochs a dispatch (the eval and checkpoint cadence)
        epochs_per_dispatch=epochs_per_dispatch or (10 if recipe else 1),
    )
    log = Logfile(f"{run_dir}/_details.txt")
    result = train_full_batch(model, g, tcfg, log=log)
    result["run_dir"] = run_dir
    return result


def main(epochs: int = 150, run_base: str = "runs", tuned: bool = False,
         raw_residual: bool = False, profile_steps: int = 0, epochs_per_dispatch: int = 0,
         device="cuda") -> Dict[str, Any]:
    """``train``, then the curves and history.csv in the run dir."""
    result = train(epochs, run_base, tuned, raw_residual, profile_steps,
                   epochs_per_dispatch, device)
    plot_history(result["history"], result["run_dir"])
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--tuned", action="store_true",
                   help="framework recipe: tfidf S=40 + precomputed scaler "
                        "+ best-val selection + ensemble eval")
    p.add_argument("--raw-residual", action="store_true",
                   help="--tuned plus the hybrid gcn2 raw-residual head")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace N steps after the first (the capture) with "
                        "torch.profiler into <run_dir>/profile")
    p.add_argument("--epochs-per-dispatch", type=int, default=0, metavar="K",
                   help="K epochs per captured graph (0 = recipe default: 10 "
                        "for --tuned/--raw-residual, else 1)")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.epochs, tuned=a.tuned, raw_residual=a.raw_residual,
         profile_steps=a.profile, epochs_per_dispatch=a.epochs_per_dispatch,
         device=a.device)
