"""Loss and metric functions (``ampnet_tpu/train/losses.py`` in torch)."""
from __future__ import annotations

from typing import Optional

import torch


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-node negative log likelihood (F.nll_loss reduction='none')."""
    return -torch.gather(log_probs, 1, labels.long()[:, None])[:, 0]


def masked_mean_nll(log_probs: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Full-batch loss: mean NLL over masked nodes."""
    m = mask.to(log_probs.dtype)
    return (nll_loss(log_probs, labels) * m).sum() / m.sum().clamp_min(1.0)


def saint_weighted_nll(log_probs: torch.Tensor, labels: torch.Tensor,
                       node_norm: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """GraphSAINT loss: sum over masked nodes of the node_norm-weighted NLL."""
    m = mask.to(log_probs.dtype)
    return (nll_loss(log_probs, labels) * node_norm * m).sum()


def saint_weighted_mean_nll(log_probs: torch.Tensor, labels: torch.Tensor,
                            node_norm: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """node_norm-weighted MEAN NLL, the stabilized GraphSAINT loss: dividing
    by the summed weights keeps the bias-correction ratios between nodes and
    an O(1) loss (the weighted sum is ~1e-1, so that L2 weight decay would
    dominate the update)."""
    w = node_norm * mask.to(log_probs.dtype)
    return (nll_loss(log_probs, labels) * w).sum() / w.sum().clamp_min(1e-12)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross entropy on logits (the sigmoid-out and XOR heads), in
    its stable form max(z, 0) - z t + log1p(exp(-|z|)); the mean over the
    masked entries when a mask is given."""
    logits = logits.reshape(-1)
    targets = targets.reshape(-1).to(logits.dtype)
    per = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    if mask is not None:
        m = mask.reshape(-1).to(logits.dtype)
        return (per * m).sum() / m.sum().clamp_min(1.0)
    return per.mean()


def masked_accuracy(log_probs: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Accuracy over masked nodes."""
    correct = (log_probs.argmax(dim=-1) == labels) & mask
    return correct.to(torch.float32).sum() / mask.to(torch.float32).sum().clamp_min(1.0)
