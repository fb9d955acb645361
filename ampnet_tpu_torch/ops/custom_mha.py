"""Full-surface multi-head attention, the reference's custom MHA clone
(``ampnet_tpu/ops/custom_mha.py`` in torch).

Covers every option of the reference's vendored MultiheadAttention
(src/ampnet/conv/custom_multihead_attn.py:46-102 and its functional
backend custom_multihead_attn_forward.py:4189-4444) that the packed-QKV
path (``ops/edge_attention.py``) does not:

  * separate q/k/v projection weights for unequal kdim / vdim;
  * add_bias_kv: a learnable bias row appended to K and V;
  * add_zero_attn: an extra all-zero K/V position;
  * key_padding_mask [B, S_k] and attn_mask [S_q, S_k], boolean (True =
    masked) or additive;
  * softmax and no-softmax mode, and the head-averaged weights.

No attention dropout (the JAX op's ``dropout_rate``): the reference runs its
MHA at 0.

AMPConv never uses these (it runs packed, same-dim, unmasked), so the hot
path stays in edge_attention.py. Parameters are in the JAX layout (x @ W);
initialization draws from an explicit CPU ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ampnet_tpu_torch.ops.edge_attention import head_scale, widened


class CustomMHAParams(NamedTuple):
    """JAX-layout parameters (x @ W; torch Linear stores W transposed). With
    kdim == vdim == embed_dim, w_q | w_k | w_v is the packed MHAParams.w_qkv."""

    w_q: torch.Tensor             # [D, D]
    w_k: torch.Tensor             # [kdim, D]
    w_v: torch.Tensor             # [vdim, D]
    b_q: torch.Tensor             # [D]
    b_k: torch.Tensor             # [D]
    b_v: torch.Tensor             # [D]
    w_out: torch.Tensor           # [D, D]
    b_out: torch.Tensor           # [D]
    bias_k: Optional[torch.Tensor] = None   # [1, D] (add_bias_kv)
    bias_v: Optional[torch.Tensor] = None   # [1, D]


def _xavier_uniform(shape, generator, dtype) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype)
    return torch.nn.init.xavier_uniform_(t, generator=generator)


def _xavier_normal_truncated(shape, generator, dtype) -> torch.Tensor:
    """JAX's xavier_normal: variance 2 / (fan_in + fan_out), a normal
    truncated at 2 std and rescaled to that variance."""
    std = math.sqrt(2.0 / (shape[0] + shape[1])) / 0.87962566103423978
    t = torch.empty(shape, dtype=dtype)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_custom_mha(
    generator: torch.Generator,
    embed_dim: int,
    kdim: Optional[int] = None,
    vdim: Optional[int] = None,
    add_bias_kv: bool = False,
    dtype: torch.dtype = torch.float32,
) -> CustomMHAParams:
    """torch _reset_parameters' init: xavier-uniform projections, zero
    biases, xavier-normal bias_k / bias_v; the out-projection keeps torch
    Linear's kaiming-uniform default (bound 1/sqrt(fan_in))."""
    d = embed_dim
    kdim, vdim = kdim or d, vdim or d
    w_q = _xavier_uniform((d, d), generator, dtype)
    w_k = _xavier_uniform((kdim, d), generator, dtype)
    w_v = _xavier_uniform((vdim, d), generator, dtype)
    bound = 1.0 / math.sqrt(d)
    w_out = torch.empty((d, d), dtype=dtype).uniform_(-bound, bound, generator=generator)
    zeros = lambda: torch.zeros(d, dtype=dtype)   # noqa: E731
    return CustomMHAParams(
        w_q=w_q, w_k=w_k, w_v=w_v, b_q=zeros(), b_k=zeros(), b_v=zeros(),
        w_out=w_out, b_out=zeros(),
        bias_k=_xavier_normal_truncated((1, d), generator, dtype) if add_bias_kv else None,
        bias_v=_xavier_normal_truncated((1, d), generator, dtype) if add_bias_kv else None,
    )


def _pad_mask_col(mask: Optional[torch.Tensor], rows: int) -> Optional[torch.Tensor]:
    """One more key column, unmasked (False, or 0 for an additive mask)."""
    if mask is None:
        return None
    return torch.cat([mask, torch.zeros((rows, 1), dtype=mask.dtype, device=mask.device)],
                     dim=1)


def custom_multihead_attention(
    query: torch.Tensor,          # [B, S_q, D]
    key: torch.Tensor,            # [B, S_k, kdim]
    value: torch.Tensor,          # [B, S_k, vdim]
    params: CustomMHAParams,
    num_heads: int,
    softmax: bool = True,
    add_zero_attn: bool = False,
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, S_k] True = masked
    attn_mask: Optional[torch.Tensor] = None,         # [S_q, S_k] bool or additive
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched MHA with the reference's full option surface. Returns (out
    [B, S_q, D], head-averaged weights [B, S_q, S_k']), S_k' counting the
    bias-kv and zero-attn positions. Scores and softmax in f32 (the JAX
    dots' preferred type), weights and outputs in the query's type."""
    b, s_q, d = query.shape
    head_dim = d // num_heads
    if head_dim * num_heads != d:
        raise ValueError("embed_dim must be divisible by num_heads")

    q = query @ params.w_q + params.b_q
    k = key @ params.w_k + params.b_k
    v = value @ params.w_v + params.b_v

    # bias_kv: one learnable extra key / value position; the masks get a
    # column for it
    if params.bias_k is not None:
        k = torch.cat([k, params.bias_k.expand(b, 1, d)], dim=1)
        v = torch.cat([v, params.bias_v.expand(b, 1, d)], dim=1)
        key_padding_mask = _pad_mask_col(key_padding_mask, b)
        attn_mask = _pad_mask_col(attn_mask, s_q)
    # add_zero_attn: an all-zero key / value position
    if add_zero_attn:
        zeros = torch.zeros((b, 1, d), dtype=k.dtype, device=k.device)
        k, v = torch.cat([k, zeros], dim=1), torch.cat([v, zeros], dim=1)
        key_padding_mask = _pad_mask_col(key_padding_mask, b)
        attn_mask = _pad_mask_col(attn_mask, s_q)

    def split(t):
        return t.reshape(b, -1, num_heads, head_dim).transpose(1, 2)

    qh = split(q) * head_scale(head_dim, q.dtype)
    kh, vh = split(k), split(v)
    scores = widened(qh) @ widened(kh).transpose(-1, -2)     # [B, H, S_q, S_k']
    neg = torch.full((), torch.finfo(scores.dtype).min, dtype=scores.dtype,
                     device=scores.device)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask[None, None], neg, scores)
        else:
            scores = scores + attn_mask[None, None].to(scores.dtype)
    if key_padding_mask is not None:
        scores = torch.where(key_padding_mask[:, None, None, :], neg, scores)

    weights = (torch.softmax(scores, dim=-1) if softmax else scores).to(q.dtype)
    out = (widened(weights) @ widened(vh)).to(q.dtype)
    out = out.transpose(1, 2).reshape(b, s_q, d)
    return out @ params.w_out + params.b_out, weights.mean(dim=1)
