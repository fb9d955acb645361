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

Types follow the JAX package's: the dots take their operands in the
data's type and sum in f32 (``preferred_element_type=float32``), the
softmax is f32, and the weights and messages round back to the data's
type; the per-receiver sums are in the messages' type. Where JAX promotes
a bf16 tensor against an f32 one (``jnp.result_type``) and torch's
products would raise, the port casts both to ``torch.promote_types``, the
same type.
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


def promoted(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors in their promoted type (``jnp.result_type``'s for the
    float types the port uses: bf16 with f32 is f32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def widened(t: torch.Tensor) -> torch.Tensor:
    """t in the type its products are summed in: bf16 in f32 (the JAX dots'
    ``preferred_element_type=float32``), f32 and f64 in their own."""
    return t.float() if t.dtype == torch.bfloat16 else t


def head_scale(head_dim: int, dtype: torch.dtype) -> float:
    """1/sqrt(head_dim) in ``dtype``, as JAX's ``asarray(scale, dtype)``
    (bf16: 1/sqrt(32) is 0.1767578125)."""
    return float(torch.tensor(1.0 / head_dim ** 0.5, dtype=dtype))


def _scores(q: torch.Tensor, k: torch.Tensor, num_heads: int,
            mdt: Optional[torch.dtype] = None) -> torch.Tensor:
    """Scores [B, H, S, S] of q scaled in its type, the products' operands
    rounded to ``mdt`` (default: the data's type), summed in f32 (f64 for
    f64 data)."""
    head_dim = q.shape[-1] // num_heads
    mdt = mdt or q.dtype
    qh = (_split_heads(q, num_heads) * head_scale(head_dim, q.dtype)).to(mdt)
    kh = _split_heads(k, num_heads).to(mdt)
    return widened(qh) @ widened(kh).transpose(-1, -2)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
           softmax: bool = True, mdt: Optional[torch.dtype] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The messages [B, S, D] and weights [B, H, S, S] of attention on
    projected rows, in f32 (f64 for f64 data): the products' operands (q
    scaled, k, the weights, v) in ``mdt`` (default: the data's type), their
    sums in f32, as the JAX package's dots and kernel bodies take them."""
    mdt = mdt or q.dtype
    scores = _scores(q, k, num_heads, mdt)
    weights = torch.softmax(scores, dim=-1) if softmax else scores
    vh = _split_heads(v, num_heads).to(mdt)
    return _merge_heads(widened(weights.to(mdt)) @ widened(vh)), weights


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    softmax: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled dot-product attention on projected [B, S, D] tensors.
    Returns (attn_out [B, S, D], head-averaged weights [B, S, S]), both in
    q's type."""
    out, weights = attend(q, k, v, num_heads, softmax)
    return out.to(q.dtype), weights.to(q.dtype).mean(dim=1)


def multihead_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    params: MHAParams,
    num_heads: int,
    softmax: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full MHA on [B, S, D] batches (torch nn.MultiheadAttention's math in
    the JAX layout): the packed projection's thirds, ``attention_core``,
    the out-projection. Returns (out [B, S, D], head-averaged weights
    [B, S, S]). No attention dropout: the reference runs its MHA at 0."""
    d = query.shape[-1]
    w, b = params.w_qkv, params.b_qkv
    q = query @ w[:, :d] + b[:d]
    k = key @ w[:, d : 2 * d] + b[d : 2 * d]
    v = value @ w[:, 2 * d :] + b[2 * d :]
    out, weights = attention_core(q, k, v, num_heads, softmax=softmax)
    return out @ params.w_out + params.b_out, weights


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
    x, w_qkv, b_qkv = promoted(x, params.w_qkv, params.b_qkv)
    q = (x @ w_qkv[:, :d] + b_qkv[:d])[receivers]
    k = (x @ w_qkv[:, d : 2 * d] + b_qkv[d : 2 * d])[senders]
    scores = _scores(q, k, num_heads)
    weights = torch.softmax(scores, dim=-1) if softmax else scores
    return weights.to(q.dtype).mean(dim=1)


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
    x, w_qkv, b_qkv = promoted(x, params.w_qkv, params.b_qkv)
    qkv = x @ w_qkv + b_qkv          # [N, S, 3D]
    q = qkv[..., :d][receivers]
    k = qkv[..., d : 2 * d][senders]
    v = qkv[..., 2 * d :][senders]
    msg, weights = attention_core(q, k, v, num_heads, softmax=softmax)

    # in msg's type, as JAX's segment_sum; the f32 count promotes the mean
    total = segment_sum(msg, receivers, num_nodes, edge_mask)
    count = segment_count(receivers, num_nodes, edge_mask)
    mean = total / count.clamp_min(1.0)[:, None, None]
    mean, w_out, b_out = promoted(mean, params.w_out, params.b_out)
    out = mean @ w_out + b_out
    out = torch.where((count > 0)[:, None, None], out, torch.zeros_like(out))
    return out, (weights if return_weights else None)
