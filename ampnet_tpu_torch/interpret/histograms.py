"""Gradient / activation introspection (``ampnet_tpu/interpret/histograms.py``
in the port).

The reference's per-model methods (visualize_gradients, plot_grad_flow,
visualize_activations) as functions over named tensors: gradients come as
``{name: tensor}`` (``{n: p.grad for n, p in model.named_parameters()}``),
activations as the model's ``ModelOutput.aux``. The numbers behind each plot
are numpy; matplotlib is imported when a plot is drawn.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np

from ampnet_tpu_torch.interpret.curves import pyplot

# the weight-like parameters a gradient plot shows (the reference keeps names
# containing 'weight'; the JAX package's names add its kernels and tables)
WEIGHT_WORDS = ("kernel", "w_", "embedding", "weight", "table", "cls")


def to_numpy(value) -> np.ndarray:
    """A tensor (any device or type: bf16 widens to f32) or array as numpy."""
    if hasattr(value, "detach"):
        value = value.detach().cpu()
        if value.dtype.is_floating_point and value.dtype.itemsize < 4:
            value = value.float()
        return value.numpy()
    return np.asarray(value)


def _flatten_weight_grads(grads: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """{name: flat array} for the weight-like entries of ``{name: gradient}``
    (None entries, parameters without a gradient, left out)."""
    return {name: to_numpy(g).reshape(-1) for name, g in grads.items()
            if g is not None and any(t in name.lower() for t in WEIGHT_WORDS)}


def visualize_gradients(
    grads: Mapping[str, Any],
    save_path: str,
    epoch_idx: int = 0,
    iteration: int = 0,
    color: str = "C0",
) -> Optional[str]:
    """Histogram grid of per-weight-tensor gradients with mean / median / std
    annotations."""
    g = _flatten_weight_grads(grads)
    if not g:
        return None
    plt = pyplot()
    out_dir = os.path.join(save_path, "gradient_distrib_plots")
    os.makedirs(out_dir, exist_ok=True)
    cols = len(g)
    fig, axes = plt.subplots(1, cols, figsize=(cols * 4, 4), squeeze=False)
    for ax, (name, vals) in zip(axes[0], sorted(g.items())):
        ax.hist(vals, bins=30, color=color)
        ax.set_title(
            f"{name}\nMean: {vals.mean():.4f}, Median: {np.median(vals):.4f}\n"
            f"STD: {vals.std():.4f}",
            fontsize=8,
        )
        ax.set_xlabel("Grad magnitude")
    fig.suptitle("Gradient Magnitude Distribution", fontsize=14, y=1.05)
    fig.subplots_adjust(wspace=0.45)
    out = os.path.join(out_dir, f"gradient_distrib_epoch{epoch_idx}_itr{iteration}.png")
    fig.savefig(out, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    return out


def plot_grad_flow(
    grads: Mapping[str, Any],
    save_path: str,
    epoch_idx: int = 0,
    iteration: int = 0,
) -> Optional[str]:
    """Mean / max |grad| per layer bar chart (vanishing / exploding gradient
    diagnostic)."""
    g = _flatten_weight_grads(grads)
    if not g:
        return None
    plt = pyplot()
    out_dir = os.path.join(save_path, "gradient_flow_plots")
    os.makedirs(out_dir, exist_ok=True)
    layers = sorted(g)
    ave = [np.abs(g[k]).mean() for k in layers]
    mx = [np.abs(g[k]).max() for k in layers]
    fig, ax = plt.subplots(figsize=(max(6, len(layers)), 5))
    xs = np.arange(len(layers))
    ax.bar(xs, mx, alpha=0.3, lw=1, color="c", label="max-gradient")
    ax.bar(xs, ave, alpha=0.5, lw=1, color="b", label="mean-gradient")
    ax.hlines(0, -0.5, len(layers) - 0.5, lw=2, color="k")
    ax.set_xticks(xs)
    ax.set_xticklabels(layers, rotation="vertical", fontsize=7)
    ax.set_ylim(bottom=-0.001, top=max(0.02, max(mx) * 1.1 if mx else 0.02))
    ax.set_xlabel("Layers")
    ax.set_ylabel("average gradient")
    ax.set_title("Gradient flow")
    ax.grid(True, alpha=0.3)
    ax.legend()
    out = os.path.join(out_dir, f"gradient_flow_ep{epoch_idx}_itr{iteration}.png")
    fig.savefig(out, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    return out


def visualize_activations(
    activations: Dict[str, Any],
    save_path: str,
    epoch_idx: int = 0,
    iteration: int = 0,
    color: str = "C0",
) -> str:
    """Histogram grid of named activation stages (``activation_stages_from_aux``)."""
    acts = {k: to_numpy(v).reshape(-1) for k, v in activations.items() if v is not None}
    plt = pyplot()
    cols = 2
    rows = max(1, math.ceil(len(acts) / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 2.7, rows * 2.5), squeeze=False)
    for i, (name, vals) in enumerate(acts.items()):
        ax = axes[i // cols][i % cols]
        ax.hist(vals, bins=50, color=color, density=True)
        ax.set_title(name, fontsize=9)
    fig.suptitle("Activation distribution", fontsize=16)
    fig.subplots_adjust(hspace=0.4, wspace=0.4)
    os.makedirs(save_path, exist_ok=True)
    out = os.path.join(save_path, f"act_distrib_ep{epoch_idx}_iter{iteration}.png")
    fig.savefig(out)
    plt.close(fig)
    return out


def activation_stages_from_aux(aux: Dict[str, Any], logits=None) -> Dict[str, np.ndarray]:
    """The reference's named stages from AMPGCN's ``ModelOutput.aux``."""
    stages = {}
    if aux.get("conv1_embedding") is not None:
        stages["AmpConv 1"] = to_numpy(aux["conv1_embedding"])
        stages["ReLU 1"] = np.maximum(stages["AmpConv 1"], 0)
    if aux.get("conv2_embedding") is not None:
        stages["AmpConv 2"] = to_numpy(aux["conv2_embedding"])
        stages["ReLU 2"] = np.maximum(stages["AmpConv 2"], 0)
    if aux.get("pooled") is not None:
        stages["Average Pooling"] = to_numpy(aux["pooled"])
    if aux.get("raw_residual") is not None:
        stages["Raw Residual"] = to_numpy(aux["raw_residual"])
    if logits is not None:
        stages["Linear Out"] = to_numpy(logits)
    return stages
