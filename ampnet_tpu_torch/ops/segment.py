"""Masked segment reductions (``ampnet_tpu/ops/segment.py`` in torch).

All ops take an explicit validity mask so padded edges contribute nothing.

On the card a segment sum is taken in a fixed order: ``index_add_`` sums
with float atomics in whatever order the threads reach them, so two runs
of one step could differ in the last bits (and Adam turns a last-bit
difference of a gradient that is rounding noise into an update of size
lr). The sort-based kernel behind ``index_put_(accumulate=True)`` sums each
segment's rows in their input order, repeatably, and reads nothing back to
the host when asked not to check the index range (``unsafe``: the ids come
from the graph, which the CPU path checks as it sums). So a captured step
and an eager one, or two runs, give the same bits. Counts stay on
``index_add_``: whole numbers sum exactly in any order.
"""
from __future__ import annotations

from typing import Optional

import torch


def segment_sum_into(
    out: torch.Tensor,
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[segment_ids[i]] += data[i]`` for every row i where ``mask``
    holds, in place; rows where it does not are selected away (they may
    hold NaN) and add nothing. On the card each segment's rows are summed
    in their input order through the sorted ``index_put_`` kernel, so two
    runs give the same bits; the masked rows' zeros then go to segments by
    position, not all to the one their id names (padding: node 0), since
    the sorted sum walks one segment's rows in one warp. The CPU's
    ``index_add_`` adds the rows one at a time in input order already."""
    if mask is not None:
        data = torch.where(mask.reshape((-1,) + (1,) * (data.ndim - 1)), data,
                           torch.zeros((), dtype=data.dtype, device=data.device))
    ids = segment_ids.long()
    if not data.is_cuda:
        return out.index_add_(0, ids, data)
    if mask is not None:
        spread = torch.arange(ids.numel(), device=ids.device) % out.shape[0]
        ids = torch.where(mask.reshape(-1), ids, spread)
    return torch.ops.aten._index_put_impl_(out, (ids,), data, True, True)


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked segment sum. data: [E, ...], segment_ids: [E] -> [N, ...]."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return segment_sum_into(out, data, segment_ids, mask)


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Masked segment count in ``dtype``. Whole numbers add exactly in any
    order, so ``index_add_``'s atomics give the same bits every run and need
    no sorted sum."""
    ones = (torch.ones(segment_ids.shape, dtype=dtype, device=segment_ids.device)
            if mask is None else mask.to(dtype))
    out = torch.zeros(num_segments, dtype=dtype, device=segment_ids.device)
    return out.index_add_(0, segment_ids.long(), ones)


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
