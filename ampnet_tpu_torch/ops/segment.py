"""Masked segment reductions (``ampnet_tpu/ops/segment.py`` in torch).

All ops take an explicit validity mask so padded edges contribute nothing.
"""
from __future__ import annotations

from typing import Optional

import torch


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked segment sum. data: [E, ...], segment_ids: [E] -> [N, ...]."""
    if mask is not None:
        data = torch.where(mask.reshape((-1,) + (1,) * (data.ndim - 1)), data,
                           torch.zeros((), dtype=data.dtype, device=data.device))
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape, dtype=dtype, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked segment mean; empty segments yield 0 (PyG scatter-mean semantics)."""
    total = segment_sum(data, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask).clamp_min(1.0)
    return total / count.reshape((-1,) + (1,) * (total.ndim - 1))
