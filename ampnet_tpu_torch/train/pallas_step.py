"""Training steps backed by the fused edge-attention kernels, the layout
passed as DATA (``ampnet_tpu/train/pallas_step.py`` in torch).

The tiled-CSR edge layout is computed per (sub)graph on the host with a
fixed per-tile edge budget and handed to the step beside the graph, so
GraphSAINT subgraphs of differing edge counts share one set of shapes. The
step reads only the layout's STRUCTURAL validity, so a layout built with
``compute_layout(..., sender_layout=False)`` (one tiled-CSR build per
subgraph, not two) is enough: the backward is then the stream backward
(K5 + pass B) where a layout with its sender side gets the scatter-free
one (K3 + K4).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.ops.hopper.edge_attention_fused import amp_edge_attention_fused
from ampnet_tpu_torch.ops.hopper.format import (  # noqa: F401  (re-exported)
    EdgeLayout,
    compute_layout,
    default_edge_budget,
)
from ampnet_tpu_torch.train.state import make_train_step


def make_fused_fns(model: torch.nn.Module, graph: Graph, layout: EdgeLayout,
                   tile_nodes: Optional[int] = None, gather: str = "auto",
                   fused_bwd: bool = True) -> Tuple[Callable, Callable]:
    """(fn, fn) for ``AMPGCN.forward(fused_fns=...)``: each ``fn(x, params)``
    is the fused op over ``graph``'s edges and ``layout``'s structural slots.
    ``tile_nodes`` is layout geometry and comes from the layout unless the
    caller overrides it. Any embedding_dim divisible by num_heads works."""
    cfg = model.config
    if tile_nodes is None:
        tile_nodes = layout.tile_nodes
    snd = {}
    if layout.snd_ptr is not None:
        snd = dict(snd_receivers=layout.snd_receivers, snd_valid=layout.snd_valid,
                   snd_ptr=layout.snd_ptr, snd_slots=layout.snd_slots)

    def fused(x, params):
        return amp_edge_attention_fused(
            x, params, graph.receivers, graph.edge_mask, layout.tile_senders,
            layout.tile_valid, layout.recv_ptr, layout.recv_slots,
            num_heads=cfg.num_heads, softmax=cfg.attn_softmax,
            tile_nodes=tile_nodes, gather=gather, fused_bwd=fused_bwd,
            senders=graph.senders, tile_recv=layout.tile_recv,
            tile_counts=layout.tile_counts, **snd)

    return (fused, fused)


def fused_forward(model: torch.nn.Module, tile_nodes: Optional[int] = None,
                  gather: str = "auto", fused_bwd: bool = True) -> Callable:
    """forward(graph, layout, generator) -> logits with both convs fused
    through closures over the layout (``make_fused_fns``): the model call of
    ``make_pallas_train_step``'s step body."""

    def forward(graph: Graph, layout: EdgeLayout, generator: torch.Generator):
        fns = make_fused_fns(model, graph, layout, tile_nodes, gather,
                             fused_bwd=fused_bwd)
        return model(graph, deterministic=False, generator=generator,
                     fused_fns=fns)

    return forward


def make_pallas_train_step(model: torch.nn.Module, loss_mode: str = "saint",
                           tile_nodes: Optional[int] = None, gather: str = "auto",
                           fused_bwd: bool = True):
    """step(state, graph, layout) -> (state, metrics) with both convs fused
    through closures over the layout (``fused_forward``); otherwise the
    step of ``train/state.py::make_train_step``, so on the card one
    CUDA-graph replay per step, captured once per layout shape (layouts of
    a fixed budget share one graph: ``compute_layout`` pads them to its
    capacity). The graph and the layout must lie on the model's device."""
    return make_train_step(model, loss_mode,
                           forward=fused_forward(model, tile_nodes, gather, fused_bwd))
