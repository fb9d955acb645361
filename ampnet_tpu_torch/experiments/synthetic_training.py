"""Early non-modular XOR trainer (``experiments/synthetic_training.py`` in
the port): probability-linked XOR graphs, AMPGCN(emb=3, heads=1, S=2,
output_dim=1, sigmoid out) or the GCN switch, Adam lr 0.01 with an MSE
loss, 200 epochs, gradient and activation plots every 4 epochs, loss and
accuracy curves, final test accuracy.

The reference's defect stays fixed as in the JAX driver: test accuracy is
measured against the TEST labels (the reference compares test predictions
with the train labels). The training step draws every random number from
the state's one generator, where the JAX driver splits its key per stream
(``split_rngs``). At this degenerate scale which inits escape MSE's
predict-the-class-mean basin is seed luck; seed 2 is the JAX driver's
default. The convs run the plain path (the JAX driver's XLA convs).

    python -m ampnet_tpu_torch.experiments.synthetic_training [--epochs 200] \\
        [--gcn] [--seed 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict

import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.data.synthetic import get_xor_graphs
from ampnet_tpu_torch.experiments.common import can_draw
from ampnet_tpu_torch.interpret.curves import history_to_csv
from ampnet_tpu_torch.models import AMPGCN, GCN
from ampnet_tpu_torch.train import Logfile, create_run_dir, create_train_state, make_optimizer

TRAIN_AMPCONV = True  # reference switch (:20)


def mse_and_acc(model, graph, generator, deterministic: bool, return_aux: bool = False):
    """(MSE of the sigmoid probabilities against the labels, accuracy at 0.5)
    over the real training nodes [, the model's aux]."""
    out = model(graph, deterministic=deterministic, generator=generator, return_aux=True)
    probs = out.logits[..., 0]
    m = graph.train_mask & graph.node_mask
    count = m.sum().clamp_min(1)
    yf = graph.y.to(torch.float32)
    loss = torch.where(m, (probs - yf) ** 2, torch.zeros_like(probs)).sum() / count
    pred = (probs > 0.5).to(graph.y.dtype)
    acc = (m & (pred == graph.y)).sum() / count
    return (loss, acc, out.aux) if return_aux else (loss, acc)


def train(epochs: int = 200, train_ampconv: bool = TRAIN_AMPCONV, run_base: str = "runs",
          viz_every: int = 4, seed: int = 2, draw: bool = True,
          device="cuda") -> Dict[str, Any]:
    """Train and evaluate every epoch; with ``draw`` (and matplotlib) the
    gradient and activation plots every ``viz_every`` epochs and the
    curves at the end. Returns the final, max test and max train
    accuracies, the history and the run dir (history.csv in it)."""
    train_g, test_g = get_xor_graphs(
        num_train_samples=40, num_test_samples=40, noise_std=0.05,
        same_class_link_prob=0.8, diff_class_link_prob=0.05, seed=1,
    )
    gen = torch.Generator().manual_seed(seed)
    if train_ampconv:
        cfg = AMPGCNConfig(
            embedding_dim=3, num_heads=1, num_node_features=2,
            num_sampled_vectors=2, output_dim=1, softmax_out=False,
            feat_emb_dim=2, val_emb_dim=1, downsample_feature_vectors=False,
            feature_repeats=1, dropout_rate=0.0, dropout_adj_rate=0.0,
        )
        model = AMPGCN(cfg, generator=gen, device=device)
    else:
        model = GCN(num_node_features=2, feat_emb_dim=2, val_emb_dim=1, output_dim=1,
                    softmax_out=False, generator=gen, device=device)
    draw = draw and can_draw()
    if draw:
        from ampnet_tpu_torch.interpret.curves import plot_acc_curves, plot_loss_curves
        from ampnet_tpu_torch.interpret.histograms import (plot_grad_flow,
                                                           visualize_activations,
                                                           visualize_gradients)

    run_dir = create_run_dir(run_base, details="early synthetic training (MSE/sigmoid)")
    grads_path, activ_path = f"{run_dir}/gradients", f"{run_dir}/activations"
    log = Logfile(f"{run_dir}/_details.txt")
    state = create_train_state(model, make_optimizer(model.parameters(), 0.01), seed=seed)
    train_g, test_g = train_g.to(device), test_g.to(device)
    dev = train_g.x.device

    history = []
    for epoch in range(epochs):
        state.optimizer.zero_grad()
        loss, acc = mse_and_acc(model, train_g, state.generator, deterministic=False)
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        state.optimizer.step()
        state.step += 1
        if draw and epoch % viz_every == 0:
            visualize_gradients(grads, grads_path, epoch, 0)
            plot_grad_flow(grads, grads_path, epoch, 0)
            with torch.no_grad():
                _, _, aux = mse_and_acc(model, train_g,
                                        torch.Generator(device=dev).manual_seed(epoch), True,
                                        return_aux=True)
            visualize_activations({k: v for k, v in aux.items()
                                   if k in ("conv1_embedding", "conv2_embedding", "pooled")},
                                  activ_path, epoch, 0)
        with torch.no_grad():
            te_loss, te_acc = mse_and_acc(model, test_g,
                                          torch.Generator(device=dev).manual_seed(epoch), True)
        row = {"epoch": epoch, "loss": float(loss.detach()), "train_acc": float(acc),
               "test_loss": float(te_loss), "test_acc": float(te_acc)}
        history.append(row)
        log.log(f"Epoch {epoch:05d} | Train Loss {row['loss']:.4f}; Acc {row['train_acc']:.4f}"
                f" | Test Loss {row['test_loss']:.4f} | Acc {row['test_acc']:.4f}")

    history_to_csv(history, os.path.join(run_dir, "history.csv"))
    if draw:
        plot_loss_curves([r["loss"] for r in history], [r["test_loss"] for r in history],
                         save_path=run_dir)
        plot_acc_curves([r["train_acc"] for r in history], [r["test_acc"] for r in history],
                        save_path=run_dir)
    te_accs = [r["test_acc"] for r in history]
    log.log(f"Final Test Accuracy: {te_accs[-1]:.4f}")
    return {"final_test_acc": te_accs[-1], "max_test_acc": max(te_accs),
            "max_train_acc": max(r["train_acc"] for r in history), "history": history,
            "run_dir": run_dir}


def main(epochs: int = 200, train_ampconv: bool = TRAIN_AMPCONV, run_base: str = "runs",
         viz_every: int = 4, seed: int = 2, device="cuda") -> Dict[str, float]:
    """``train`` with its plots; the three accuracies."""
    result = train(epochs, train_ampconv, run_base, viz_every, seed, True, device)
    return {k: result[k] for k in ("final_test_acc", "max_test_acc", "max_train_acc")}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--gcn", action="store_true")
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.epochs, train_ampconv=not a.gcn, seed=a.seed, device=a.device)
