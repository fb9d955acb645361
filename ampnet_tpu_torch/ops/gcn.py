"""GCN normalized sparse aggregation (``ampnet_tpu/ops/gcn.py`` in torch):
D^-1/2 (A + I) D^-1/2 as masked segment ops over the edge list."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ampnet_tpu_torch.ops.segment import segment_count, segment_sum


def gcn_norm(
    senders: torch.Tensor,
    receivers: torch.Tensor,
    num_nodes: int,
    edge_mask: Optional[torch.Tensor] = None,
    add_self_loops: bool = True,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """GCN edge weights 1/sqrt(deg(s) deg(r)) in ``dtype``, degrees counted
    with self-loops over masked-in edges. Returns (senders', receivers',
    edge_weight, edge_mask')."""
    if add_self_loops:
        loops = torch.arange(num_nodes, dtype=senders.dtype, device=senders.device)
        senders = torch.cat([senders, loops])
        receivers = torch.cat([receivers, loops])
        if edge_mask is not None:
            edge_mask = torch.cat([edge_mask, torch.ones(
                num_nodes, dtype=torch.bool, device=edge_mask.device)])
    deg = segment_count(receivers, num_nodes, edge_mask, dtype)
    dinv = torch.where(deg > 0, 1.0 / deg.clamp_min(1.0).sqrt(), torch.zeros_like(deg))
    w = dinv[senders] * dinv[receivers]
    if edge_mask is not None:
        w = torch.where(edge_mask, w, torch.zeros_like(w))
    return senders, receivers, w, edge_mask


def gcn_aggregate(
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    num_nodes: int,
    edge_mask: Optional[torch.Tensor] = None,
    add_self_loops: bool = True,
) -> torch.Tensor:
    """out = D^-1/2 (A+I) D^-1/2 @ x via gather + weighted segment-sum, the
    normalization in x's type (a float64 forward is float64 throughout)."""
    s, r, w, m = gcn_norm(senders, receivers, num_nodes, edge_mask, add_self_loops, x.dtype)
    msgs = x[s] * w.reshape((-1,) + (1,) * (x.ndim - 1))
    return segment_sum(msgs, r, num_nodes, m)
