"""Modular XOR trainer (``experiments/synthetic_training_modular.py`` in the
port): an ``ARGS`` dict config, NLL loss, grad clip 1.0, a checkpoint
every 20 epochs, and ``train_model(...) -> (max train acc, max test acc)``,
which ``grid_search`` imports.

The AMPNet model (``get_model('AMPNet')``, D=32 H=2 S=20) runs its convs
on the fused kernels (K1 forward, K3 + K4 backward, K1 or K2 in the test
eval), where the JAX driver runs its XLA convs; its other options are the
JAX driver's. The other models of the registry take no layout.

    python -m ampnet_tpu_torch.experiments.synthetic_training_modular \\
        [--model AMPNet] [--epochs 200] [--noise-std 0.3] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ampnet_tpu_torch.data.synthetic import get_duplicated_xor_graphs, get_xor_graphs
from ampnet_tpu_torch.experiments.common import can_draw
from ampnet_tpu_torch.interpret.curves import history_to_csv, plot_history
from ampnet_tpu_torch.models import get_model
from ampnet_tpu_torch.ops.hopper.format import compute_layout
from ampnet_tpu_torch.train import (
    Logfile,
    create_run_dir,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    save_checkpoint,
)

ARGS = {
    "model_name": "AMPNet",      # AMPNet | GCN | LinearLayer | TwoLayerSigmoid
    "duplicated_features": True,
    "feature_repeats": 5,
    "num_train_samples": 400,
    "num_test_samples": 400,
    "noise_std": 0.3,
    "num_nearest_neighbors": 10,
    "epochs": 200,
    "learning_rate": 5e-3,
    "embedding_dim": 32,
    "num_heads": 2,
    "num_sampled_vectors": 20,
    "seed": 0,
}


def build_model(args: Dict[str, Any], n_feats: int, device="cuda"):
    """The registry's model of ``args['model_name']`` with the JAX driver's
    options, its weights from a generator seeded ``args['seed']``."""
    gen = torch.Generator().manual_seed(args["seed"])
    name = args["model_name"]
    if name == "AMPNet":
        return get_model(
            "AMPNet",
            embedding_dim=args["embedding_dim"], num_heads=args["num_heads"],
            num_node_features=n_feats,
            num_sampled_vectors=args["num_sampled_vectors"],
            output_dim=2,
            feat_emb_dim=args["embedding_dim"] - 1, val_emb_dim=1,
            dropout_rate=0.0, dropout_adj_rate=0.0, use_pallas=True,
            generator=gen, device=device,
        )
    if name == "GCN":
        return get_model("GCN", num_node_features=n_feats, feat_emb_dim=7, val_emb_dim=1,
                         output_dim=2, generator=gen, device=device)
    # the MLP baselines take their input width at construction (flax infers
    # it), and two outputs for the NLL over two classes (the JAX driver's
    # registry default of one output gathers past it)
    return get_model(name, in_dim=n_feats, out_dim=2, generator=gen, device=device)


def train(args: Optional[Dict[str, Any]] = None, run_base: str = "runs",
          log: Optional[Logfile] = None, device="cuda") -> Dict[str, Any]:
    """Train and evaluate every epoch (the test graph, one token draw from a
    generator seeded with the epoch); returns the history, the max train
    and test accuracies and the run dir (history.csv and the checkpoints
    in it)."""
    args = {**ARGS, **(args or {})}
    assert args["num_train_samples"] % 4 == 0
    if args["duplicated_features"]:
        train_g, test_g = get_duplicated_xor_graphs(
            args["num_train_samples"], args["num_test_samples"],
            args["noise_std"], args["num_nearest_neighbors"],
            args["feature_repeats"], seed=args["seed"],
        )
        n_feats = 2 * args["feature_repeats"]
    else:
        train_g, test_g = get_xor_graphs(
            args["num_train_samples"], args["num_test_samples"],
            args["noise_std"], seed=args["seed"],
        )
        n_feats = 2

    run_dir = create_run_dir(run_base, details=str(args))
    log = log or Logfile(f"{run_dir}/_details.txt")
    model = build_model(args, n_feats, device)
    fused = args["model_name"] == "AMPNet"
    train_g, test_g = train_g.to(device), test_g.to(device)
    lay_train = compute_layout(train_g) if fused else None
    lay_test = compute_layout(test_g) if fused else None

    state = create_train_state(
        model, make_optimizer(model.parameters(), args["learning_rate"], grad_clip=1.0),
        seed=args["seed"])
    step = make_train_step(model, loss_mode="full")
    eval_step = make_eval_step(model)

    history, max_train, max_test = [], 0.0, 0.0
    for epoch in range(args["epochs"]):
        state, metrics = step(state, train_g, lay_train)
        test_m = eval_step(test_g, torch.Generator(device=test_g.x.device).manual_seed(epoch),
                           lay_test)
        row = {
            "epoch": epoch,
            "loss": float(metrics["loss"]),
            "train_acc": float(metrics["train_acc"]),
            "test_acc": float(test_m["train_acc"]),
        }
        history.append(row)
        max_train = max(max_train, row["train_acc"])
        max_test = max(max_test, row["test_acc"])
        if epoch % 20 == 0:
            log.log(f"Epoch {epoch:4d} | loss {row['loss']:.4f} | "
                    f"train {row['train_acc']:.4f} | test {row['test_acc']:.4f}")
            save_checkpoint(os.path.join(run_dir, f"checkpoint_ep{epoch}.pkl"), state, epoch,
                            row["loss"])
    history_to_csv(history, os.path.join(run_dir, "history.csv"))
    log.log(f"Max train acc {max_train:.4f} | max test acc {max_test:.4f}")
    return {"history": history, "max_train_acc": max_train, "max_test_acc": max_test,
            "run_dir": run_dir}


def train_model(args: Optional[Dict[str, Any]] = None, run_base: str = "runs",
                log: Optional[Logfile] = None, device="cuda") -> Tuple[float, float]:
    """``train``, then the curves where matplotlib is installed; returns
    (max train acc, max test acc)."""
    result = train(args, run_base, log, device)
    if can_draw():
        plot_history(result["history"], result["run_dir"])
    return result["max_train_acc"], result["max_test_acc"]


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=ARGS["model_name"])
    p.add_argument("--epochs", type=int, default=ARGS["epochs"])
    p.add_argument("--noise-std", type=float, default=ARGS["noise_std"])
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    train_model({"model_name": a.model, "epochs": a.epochs, "noise_std": a.noise_std},
                device=a.device)
