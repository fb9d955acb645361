"""Graph conv layers: AMPConv (edge attention) and GCNConv (baseline).

Port of ``ampnet_tpu/models/layers.py``. Parameters keep the JAX
package's layout (``w_qkv`` [D, 3D], ``w_out`` [D, D] as (in, out)) and
its torch-MHA init: xavier-uniform ``w_qkv``, kaiming-uniform ``w_out``
(torch Linear's default), zero biases. Initialization draws from an
explicit CPU ``torch.Generator``; move the module with ``.to(device)``.
The training-time noise (``dropout``, ``dropout_edges``) draws from an
explicit generator on the tensor's device.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ampnet_tpu_torch.ops.edge_attention import (
    MHAParams,
    amp_edge_attention,
    edge_attention_weights,
)
from ampnet_tpu_torch.ops.gcn import gcn_aggregate
from ampnet_tpu_torch.ops.hopper.edge_attention_fused import amp_edge_attention_fused
from ampnet_tpu_torch.ops.hopper.format import (
    EdgeLayout,
    edge_slot_valid,
    snd_slot_valid,
)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate). rate 0 returns x itself and draws nothing."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


def dropout_edges(generator: torch.Generator, edge_mask: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """Randomly drop edges (PyG dropout_adj): each real edge kept with
    probability 1 - rate; a masked edge stays masked."""
    keep = torch.rand(edge_mask.shape, generator=generator,
                      device=edge_mask.device) >= rate
    return edge_mask & keep


class AMPConv(nn.Module):
    """Per-edge multi-head cross-attention message passing.

    forward: (x [N,S,D], senders [E], receivers [E], edge_mask [E]) ->
             (out [N,S,D], head-averaged attention weights [E,S,S] | None)

    With ``use_pallas`` and a layout, the layer runs the fused Hopper
    kernels, forward and backward (any D divisible by num_heads: no TPU
    lane constraint): the scatter-free backward when the layout has its
    sender side, the stream backward when it has none. ``fused_fn(x,
    params)`` replaces the call the layer would build itself
    (``train/pallas_step.py::make_fused_fns``)."""

    def __init__(self, embed_dim: int, num_heads: int, softmax: bool = True,
                 use_pallas: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = embed_dim
        self.embed_dim, self.num_heads = d, num_heads
        self.softmax, self.use_pallas = softmax, use_pallas
        self.w_qkv = nn.Parameter(torch.empty(d, 3 * d))
        self.b_qkv = nn.Parameter(torch.zeros(3 * d))
        self.w_out = nn.Parameter(torch.empty(d, d))
        self.b_out = nn.Parameter(torch.zeros(d))
        with torch.no_grad():
            nn.init.xavier_uniform_(self.w_qkv, generator=generator)
            bound = 1.0 / math.sqrt(d)   # kaiming-uniform, a=sqrt(5)
            self.w_out.uniform_(-bound, bound, generator=generator)

    def params(self) -> MHAParams:
        return MHAParams(self.w_qkv, self.b_qkv, self.w_out, self.b_out)

    def forward(
        self,
        x: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        edge_mask: Optional[torch.Tensor] = None,
        return_weights: bool = True,
        layout: Optional[EdgeLayout] = None,
        fused_fn: Optional[Callable[[torch.Tensor, MHAParams], torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if x.shape[-1] != self.embed_dim:
            raise ValueError(f"expected last dim {self.embed_dim}, got {tuple(x.shape)}")
        params = self.params()
        if fused_fn is None and self.use_pallas and layout is not None:
            # the runtime edge mask reaches the kernels through validity, on
            # the receiver side and (for the backward) the sender side alike;
            # trip counts stay structural (layout.recv_ptr, layout.snd_ptr)
            tile_valid = (layout.tile_valid if edge_mask is None
                          else edge_slot_valid(layout, edge_mask))
            snd = {}
            if layout.snd_ptr is not None and torch.is_grad_enabled():
                snd = dict(
                    snd_receivers=layout.snd_receivers,
                    snd_valid=(layout.snd_valid if edge_mask is None
                               else snd_slot_valid(layout, edge_mask)),
                    snd_ptr=layout.snd_ptr, snd_slots=layout.snd_slots)

            def fused_fn(xx, pp):
                return amp_edge_attention_fused(
                    xx, pp, receivers, edge_mask, layout.tile_senders,
                    tile_valid, layout.recv_ptr, layout.recv_slots,
                    num_heads=self.num_heads, softmax=self.softmax,
                    tile_nodes=layout.tile_nodes, **snd)

        if fused_fn is not None:
            out = fused_fn(x, params)
            weights = (edge_attention_weights(x, senders, receivers, params,
                                              self.num_heads, softmax=self.softmax)
                       if return_weights else None)
            return out, weights
        return amp_edge_attention(
            x, senders, receivers, edge_mask, params, self.num_heads,
            softmax=self.softmax, return_weights=return_weights)


class GCNConv(nn.Module):
    """Kipf-Welling GCN layer: out = D^-1/2 (A+I) D^-1/2 X W + b
    (glorot kernel, zero bias; transform, then propagate)."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = nn.Linear(in_features, features, bias=False)
        self.bias = nn.Parameter(torch.zeros(features))
        with torch.no_grad():
            nn.init.xavier_uniform_(self.lin.weight, generator=generator)

    def forward(self, x, senders, receivers, edge_mask=None):
        h = self.lin(x)
        return gcn_aggregate(h, senders, receivers, x.shape[0], edge_mask) + self.bias
