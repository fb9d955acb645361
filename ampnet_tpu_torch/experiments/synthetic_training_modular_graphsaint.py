"""Modular XOR trainer, GraphSAINT variant
(``experiments/synthetic_training_modular_graphsaint.py`` in the port):
train and test each streamed through their own GraphSAINT sampler (the
native core, the default), a node_norm-weighted NLL sum.

The AMPNet model runs its convs on the fused kernels (as
``synthetic_training_modular``'s), each subgraph's layout at its
sampler's fixed edge budget, so that all steps share one captured graph.

    python -m ampnet_tpu_torch.experiments.synthetic_training_modular_graphsaint \\
        [--epochs 50] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler
from ampnet_tpu_torch.data.synthetic import create_duplicated_xor_data
from ampnet_tpu_torch.experiments.synthetic_training_modular import ARGS
from ampnet_tpu_torch.interpret.curves import history_to_csv
from ampnet_tpu_torch.models import get_model
from ampnet_tpu_torch.ops.hopper.format import compute_layout
from ampnet_tpu_torch.train import (
    Logfile,
    create_run_dir,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from ampnet_tpu_torch.train.loop import _saint_layout_budget


def train(args: Optional[Dict[str, Any]] = None, run_base: str = "runs",
          device="cuda") -> Dict[str, Any]:
    """Train; per epoch every subgraph of the train sampler, then one test
    subgraph's eval (one token draw from a generator seeded with the
    epoch). Returns the history, the max accuracies and the run dir."""
    args = {**ARGS, **(args or {})}
    rng = np.random.default_rng(args["seed"])
    samplers = []
    for ns in (args["num_train_samples"], args["num_test_samples"]):
        x, y, _, ei = create_duplicated_xor_data(
            ns, args["noise_std"], args["num_nearest_neighbors"],
            args["feature_repeats"], rng,
        )
        samplers.append(
            GraphSaintRandomWalkSampler(
                x, ei, y=y.astype(np.int32), train_mask=np.ones(ns, bool),
                batch_size=4, walk_length=20, num_steps=10, sample_coverage=20,
                seed=args["seed"],
            )
        )
    train_sampler, test_sampler = samplers
    n_feats = 2 * args["feature_repeats"]
    model = get_model(
        "AMPNet",
        embedding_dim=args["embedding_dim"], num_heads=args["num_heads"],
        num_node_features=n_feats, num_sampled_vectors=args["num_sampled_vectors"],
        output_dim=2, feat_emb_dim=args["embedding_dim"] - 1, val_emb_dim=1,
        dropout_rate=0.0, dropout_adj_rate=0.0, use_pallas=True,
        generator=torch.Generator().manual_seed(args["seed"]), device=device,
    )
    # the JAX driver initializes on one sampled subgraph: the stream moves on
    train_sampler.sample()
    state = create_train_state(
        model, make_optimizer(model.parameters(), args["learning_rate"], grad_clip=1.0),
        seed=args["seed"])
    step = make_train_step(model, loss_mode="saint")
    eval_step = make_eval_step(model)
    budgets = [_saint_layout_budget(s) for s in samplers]

    def layout(sub, budget):
        return compute_layout(sub, edges_per_tile=budget).to(device)

    run_dir = create_run_dir(run_base, details=str(args))
    log = Logfile(f"{run_dir}/_details.txt")
    history, max_train, max_test = [], 0.0, 0.0
    for epoch in range(args["epochs"]):
        for sub in train_sampler:
            state, metrics = step(state, sub.to(device), layout(sub, budgets[0]))
        test_sub = test_sampler.sample()
        test_m = eval_step(test_sub.to(device),
                           torch.Generator(device=device).manual_seed(epoch),
                           layout(test_sub, budgets[1]))
        tr, te = float(metrics["train_acc"]), float(test_m["train_acc"])
        history.append({"epoch": epoch, "loss": float(metrics["loss"]), "train_acc": tr,
                        "test_acc": te})
        max_train, max_test = max(max_train, tr), max(max_test, te)
        if epoch % 10 == 0:
            log.log(f"Epoch {epoch:4d} | loss {history[-1]['loss']:.4f} | "
                    f"train {tr:.4f} | test {te:.4f}")
    history_to_csv(history, os.path.join(run_dir, "history.csv"))
    log.log(f"Max train acc {max_train:.4f} | max test acc {max_test:.4f}")
    return {"history": history, "max_train_acc": max_train, "max_test_acc": max_test,
            "run_dir": run_dir}


def train_model(args: Optional[Dict[str, Any]] = None, run_base: str = "runs",
                device="cuda"):
    """(max train acc, max test acc) of ``train``."""
    result = train(args, run_base, device)
    return result["max_train_acc"], result["max_test_acc"]


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    train_model({"epochs": a.epochs}, device=a.device)
