"""Cora GraphSAINT training (``experiments/cora_benchmark_graphsaint.py`` in
the port): AMPGCN at D=128, H=4, S=20, the random-walk sampler (8 roots x
150 steps, 200 subgraphs an epoch, coverage 100, seed 1, on the native
core), Adam lr 0.1 wd 1e-4 with warm restarts T0=400 T_mult=2 stepped per
subgraph, 50 epochs, final full-graph test accuracy: the reference's
recipe, which diverges.

``--stabilized`` is the recipe that learns: 40 TF-IDF tokens with the
full graph's scaler, lr 3e-3, clip 1.0, the node_norm-weighted mean loss,
best-validation selection every epoch with an 8-draw eval; ``--decay-lr``
one cosine cycle over the run; ``--fused`` the fused Hopper kernels (no
edge dropout); ``--raw-residual`` the gcn2 head; ``--gcn`` the GCN
baseline instead of AMPGCN.

    python -m ampnet_tpu_torch.experiments.cora_benchmark_graphsaint \\
        --stabilized --fused --raw-residual --decay-lr
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

from ampnet_tpu_torch.core.config import AMPGCNConfig, TrainConfig, replace
from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler
from ampnet_tpu_torch.experiments.common import cora_graph
from ampnet_tpu_torch.interpret.curves import plot_history
from ampnet_tpu_torch.models import AMPGCN, GCN
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train import Logfile, create_run_dir, train_saint

TRAIN_AMPCONV = True  # the reference's switch


def train(epochs: int = 50, steps_per_epoch: int = 200, train_ampconv: bool = TRAIN_AMPCONV,
          run_base: str = "runs", fused: bool = False, stabilized: bool = False,
          decay_lr: bool = False, raw_residual: bool = False, profile_steps: int = 0,
          device="cuda") -> Dict[str, Any]:
    """Train and return ``train_saint``'s result, with ``run_dir``."""
    np.random.seed(1)  # the reference's seeds
    d, full_g = cora_graph()
    sampler = GraphSaintRandomWalkSampler(
        d.x, d.edge_index, y=d.y,
        train_mask=d.train_mask, val_mask=d.val_mask, test_mask=d.test_mask,
        batch_size=8, walk_length=150, num_steps=steps_per_epoch,
        sample_coverage=100, seed=1,
    )
    # stabilized: one scaler fit on the full graph, so that subgraphs and
    # the full-graph eval are normalized alike (the reference refits it on
    # every forward, and subgraph training then never moves the eval)
    scaler_stats = fit_scaler(d.x) if stabilized else None
    if train_ampconv:
        cfg = AMPGCNConfig(
            embedding_dim=128, num_heads=4, num_node_features=1433,
            num_sampled_vectors=40 if stabilized else 20,
            output_dim=7, feat_emb_dim=127, val_emb_dim=1,
            token_sampling="tfidf" if stabilized else "uniform",
            scaler="precomputed" if stabilized else "batch",
            dropout_adj_rate=0.0 if fused else 0.1,
            use_pallas=fused,
            raw_residual="gcn2" if raw_residual else False,
        )
        model = AMPGCN(cfg, scaler_stats=scaler_stats, device=device)
    else:
        model = GCN(num_node_features=1433, feat_emb_dim=127, val_emb_dim=1, output_dim=7,
                    scaler_stats=scaler_stats, device=device)

    run_dir = create_run_dir(
        run_base,
        details=f"cora graphsaint ampconv={train_ampconv} stabilized={stabilized}",
    )
    if stabilized:
        tcfg = TrainConfig(
            learning_rate=3e-3, weight_decay=5e-4, epochs=epochs,
            cosine_t0=(epochs * steps_per_epoch if decay_lr else None),
            cosine_t_mult=1,
            grad_clip=1.0, checkpoint_every=10,
            run_dir=run_dir, select_best_every=1, num_eval_samples=8,
            log_every_steps=50, saint_loss="mean",
        )
    else:
        # the reference's recipe (it diverges: kept as its record)
        tcfg = TrainConfig(
            learning_rate=0.1, weight_decay=1e-4, epochs=epochs,
            cosine_t0=400, cosine_t_mult=2, checkpoint_every=10, run_dir=run_dir,
        )
    if profile_steps:
        tcfg = replace(tcfg, profile_steps=profile_steps)
    log = Logfile(f"{run_dir}/_details.txt")
    result = train_saint(model, sampler, full_g, tcfg, log=log)
    result["run_dir"] = run_dir
    return result


def main(epochs: int = 50, steps_per_epoch: int = 200, train_ampconv: bool = TRAIN_AMPCONV,
         run_base: str = "runs", fused: bool = False, stabilized: bool = False,
         decay_lr: bool = False, raw_residual: bool = False, profile_steps: int = 0,
         device="cuda") -> Dict[str, Any]:
    """``train``, then the curves and history.csv in the run dir."""
    result = train(epochs, steps_per_epoch, train_ampconv, run_base, fused, stabilized,
                   decay_lr, raw_residual, profile_steps, device)
    plot_history(result["history"], result["run_dir"])
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--gcn", action="store_true", help="train the GCN baseline instead")
    p.add_argument("--fused", action="store_true",
                   help="fused Hopper conv kernels (cfg.use_pallas)")
    p.add_argument("--stabilized", action="store_true",
                   help="the stable SAINT recipe (the default replicates the "
                        "reference's diverging lr=0.1 schedule)")
    p.add_argument("--raw-residual", action="store_true",
                   help="hybrid head: 2 GCN hops over z-scored raw features "
                        "concatenated to the pooled tokens")
    p.add_argument("--decay-lr", action="store_true",
                   help="with --stabilized: one cosine LR cycle over the run")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace N steps after the first (the capture) with "
                        "torch.profiler into <run_dir>/profile")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.epochs, a.steps, train_ampconv=not a.gcn, fused=a.fused,
         stabilized=a.stabilized, decay_lr=a.decay_lr,
         raw_residual=a.raw_residual, profile_steps=a.profile, device=a.device)
