"""Loss and metric functions (``ampnet_tpu/train/losses.py`` in torch)."""
from __future__ import annotations

import torch


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-node negative log likelihood (F.nll_loss reduction='none')."""
    return -torch.gather(log_probs, 1, labels.long()[:, None])[:, 0]


def masked_mean_nll(log_probs: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Full-batch loss: mean NLL over masked nodes."""
    m = mask.to(log_probs.dtype)
    return (nll_loss(log_probs, labels) * m).sum() / m.sum().clamp_min(1.0)


def masked_accuracy(log_probs: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Accuracy over masked nodes."""
    correct = (log_probs.argmax(dim=-1) == labels) & mask
    return correct.to(torch.float32).sum() / mask.to(torch.float32).sum().clamp_min(1.0)
