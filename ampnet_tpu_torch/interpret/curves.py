"""Loss/accuracy curve plotting + CSV export (``ampnet_tpu/interpret/curves.py``
in the port). ``history_to_csv`` is plain csv; the plots import matplotlib
(the Agg backend) when they draw, so that importing this module needs no
drawing library."""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence


def pyplot():
    """matplotlib.pyplot on the Agg backend, imported at the first drawing."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_loss_curves(
    train_losses: Sequence[float],
    test_losses: Optional[Sequence[float]] = None,
    save_path: str = ".",
    log_scale: bool = False,
) -> str:
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.plot(train_losses, label="Train Loss")
    if test_losses is not None:
        ax.plot(test_losses, label="Test Loss")
    if log_scale:
        ax.set_yscale("log")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.set_title("Loss Curves")
    ax.legend()
    ax.grid(alpha=0.3)
    name = "loss_curves_log.png" if log_scale else "loss_curves.png"
    out = os.path.join(save_path, name)
    fig.savefig(out, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    return out


def plot_acc_curves(
    train_accs: Sequence[float],
    test_accs: Optional[Sequence[float]] = None,
    save_path: str = ".",
) -> str:
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.plot(train_accs, label="Train Accuracy")
    if test_accs is not None:
        ax.plot(test_accs, label="Test Accuracy")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Accuracy")
    ax.set_ylim(0, 1.05)
    ax.set_title("Accuracy Curves")
    ax.legend()
    ax.grid(alpha=0.3)
    out = os.path.join(save_path, "acc_curves.png")
    fig.savefig(out, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    return out


def history_to_csv(history: List[Dict[str, float]], path: str) -> str:
    """One row per history entry, the columns every key of any row, sorted."""
    if not history:
        return path
    keys = sorted({k for row in history for k in row})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for row in history:
            w.writerow(row)
    return path


def plot_history(history: List[Dict[str, float]], save_path: str) -> None:
    """Loss (linear and log) and accuracy curves and history.csv from a
    training loop's history."""
    os.makedirs(save_path, exist_ok=True)
    losses = [h["loss"] for h in history if "loss" in h]
    test_losses = [h["test_loss"] for h in history] if all("test_loss" in h for h in history) else None
    plot_loss_curves(losses, test_losses, save_path)
    plot_loss_curves(losses, test_losses, save_path, log_scale=True)
    tr = [h.get("train_acc") for h in history if "train_acc" in h]
    te = [h["test_acc"] for h in history] if all("test_acc" in h for h in history) else None
    if tr:
        plot_acc_curves(tr, te, save_path)
    history_to_csv(history, os.path.join(save_path, "history.csv"))
