"""Freeze check (``experiments/ampnet_freeze_check.py`` in the port): train
with every parameter frozen except the final linear head (and optionally
the tokenizer); if accuracy still improves, the attention layers' random
features alone carry signal, a sanity harness that the trained attention
layers do real work when unfrozen runs beat this.

Frozen parameters take ``requires_grad=False`` and stay out of the
optimizer (the JAX driver's optax mask: ``set_to_zero`` on them); they
must come out bit for bit as they went in. The convs run the plain path
on the card (the JAX driver's model leaves ``use_pallas`` off).

    python -m ampnet_tpu_torch.experiments.ampnet_freeze_check [--epochs 100] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.data.synthetic import get_duplicated_xor_graphs
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.train import create_train_state, make_optimizer, make_train_step


def train_model(epochs: int = 100, also_train_tokenizer: bool = True,
                device="cuda") -> Dict[str, Any]:
    """Train the head (and the tokenizer); returns the state, the losses
    and train accuracies by epoch, the trainable parameters' names and the
    largest change of any conv1 parameter (0 when the freeze holds)."""
    train_g, _ = get_duplicated_xor_graphs(400, 64, 0.3, 10, 5, seed=0)
    cfg = AMPGCNConfig(
        embedding_dim=32, num_heads=2, num_node_features=10,
        num_sampled_vectors=8, output_dim=2, feat_emb_dim=31, val_emb_dim=1,
        dropout_rate=0.0, dropout_adj_rate=0.0,
    )
    model = AMPGCN(cfg, generator=torch.Generator().manual_seed(0), device=device)
    trainable = {"final_linear_out"}
    if also_train_tokenizer:
        trainable.add("tokenizer")
    for name, p in model.named_parameters():
        p.requires_grad_(name.split(".")[0] in trainable)
    params = [p for p in model.parameters() if p.requires_grad]
    state = create_train_state(model, make_optimizer(params, 5e-3, grad_clip=1.0), seed=0)
    frozen_before = {k: v.detach().clone() for k, v in model.conv1.named_parameters()}
    step = make_train_step(model, loss_mode="full")
    train_g = train_g.to(device)
    losses, accs = [], []
    for epoch in range(epochs):
        state, metrics = step(state, train_g)
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["train_acc"]))
        if epoch % 20 == 0:
            print(f"epoch {epoch:4d} | loss {losses[-1]:.4f} | train acc {accs[-1]:.4f}")
    delta = max(float((v - frozen_before[k]).abs().max())
                for k, v in model.conv1.named_parameters())
    print("conv1 max param delta (must be 0):", delta)
    return {"state": state, "losses": losses, "train_accs": accs,
            "trainable": sorted(n for n, p in model.named_parameters() if p.requires_grad),
            "conv1_max_delta": delta}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    train_model(a.epochs, device=a.device)
