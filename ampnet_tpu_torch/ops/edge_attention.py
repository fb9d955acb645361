"""Per-edge multi-head cross-attention — the AMPNet core op in plain torch.

Port of ``ampnet_tpu/ops/edge_attention.py`` and the oracle every fused
kernel of the port is held against. Semantics match torch
nn.MultiheadAttention as the reference uses it (query = destination
node's tokens, key/value = source node's tokens, batched over edges) and
its no-softmax variant (scale q by 1/sqrt(head_dim), q k^T, optional
softmax, times v).

Order of work (numerically the same as the reference, far fewer FLOPs):
QKV projections run once per NODE and the projected rows are gathered
per edge; the output projection runs after the per-receiver mean, and
receivers with no live in-edge come out exactly 0 (scatter-mean's
empty-segment semantics).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ampnet_tpu_torch.ops.segment import segment_count, segment_sum


class MHAParams(NamedTuple):
    """Attention parameters in the JAX package's layout.

    w_qkv: [D, 3D] so that (x @ w_qkv + b_qkv) = packed q|k|v.
    """

    w_qkv: torch.Tensor   # [D, 3D]
    b_qkv: torch.Tensor   # [3D]
    w_out: torch.Tensor   # [D, D]
    b_out: torch.Tensor   # [D]


def _split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, D] -> [B, H, S, Dh]."""
    b, s, d = t.shape
    return t.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[B, H, S, Dh] -> [B, S, D]."""
    b, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(b, s, h * dh)


def _scores(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> torch.Tensor:
    head_dim = q.shape[-1] // num_heads
    qh = _split_heads(q, num_heads) * (1.0 / head_dim ** 0.5)
    return qh @ _split_heads(k, num_heads).transpose(-1, -2)   # [B, H, S, S]


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    softmax: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled dot-product attention on projected [B, S, D] tensors.
    Returns (attn_out [B, S, D], head-averaged weights [B, S, S])."""
    scores = _scores(q, k, num_heads)
    weights = torch.softmax(scores, dim=-1) if softmax else scores
    out = _merge_heads(weights @ _split_heads(v, num_heads))
    return out, weights.mean(dim=1)


def edge_attention_weights(
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    params: MHAParams,
    num_heads: int,
    softmax: bool = True,
) -> torch.Tensor:
    """Head-averaged attention weights [E, S, S] only — no value path, no
    aggregation (the interpretability companion to the fused kernels,
    which never materialize per-edge weights)."""
    d = x.shape[-1]
    q = (x @ params.w_qkv[:, :d] + params.b_qkv[:d])[receivers]
    k = (x @ params.w_qkv[:, d : 2 * d] + params.b_qkv[d : 2 * d])[senders]
    scores = _scores(q, k, num_heads)
    weights = torch.softmax(scores, dim=-1) if softmax else scores
    return weights.mean(dim=1)


def amp_edge_attention(
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: Optional[torch.Tensor],
    params: MHAParams,
    num_heads: int,
    num_nodes: Optional[int] = None,
    softmax: bool = True,
    return_weights: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """AMPConv message+aggregate: per-edge cross-attention, mean per receiver.

    x: [N, S, D] node tokens. Per edge e: message =
    MHA(query=x[receivers[e]], key=value=x[senders[e]]); output[n] = mean
    over live incoming edges. Returns (out [N, S, D], head-averaged
    weights [E, S, S] or None).
    """
    n, s, d = x.shape
    if num_nodes is None:
        num_nodes = n
    qkv = x @ params.w_qkv + params.b_qkv          # [N, S, 3D]
    q = qkv[..., :d][receivers]
    k = qkv[..., d : 2 * d][senders]
    v = qkv[..., 2 * d :][senders]
    msg, weights = attention_core(q, k, v, num_heads, softmax=softmax)

    total = segment_sum(msg, receivers, num_nodes, edge_mask)
    count = segment_count(receivers, num_nodes, edge_mask)
    mean = total / count.clamp_min(1.0)[:, None, None]
    out = mean @ params.w_out + params.b_out
    out = torch.where((count > 0)[:, None, None], out, torch.zeros_like(out))
    return out, (weights if return_weights else None)
