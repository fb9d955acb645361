"""Inference/serving wrapper (``ampnet_tpu/serving.py`` in torch).

A thin production surface over a trained model: one forward per padded
graph shape (shape buckets), token draws from the Predictor's own seeded
generator, the fused Hopper convs when the config asks for them, and a
params hot swap for checkpoint rollover.

On the card each bucket's forward is one captured CUDA graph of one
``train/state.py::make_predict_step`` (its ``GraphCache`` keys on the
graph's and layout's shapes), replayed with one host call: the port's
counterpart of the JAX package's ``jit`` per padded shape. The graph reads
the model's parameter tensors, so the hot swap copies a checkpoint's params
into those tensors in place and the next replay uses them without a new
capture.

With ``use_pallas`` a request's edge layout is built on the host from the
padded host graph (``compute_layout``), before the graph goes to the card,
at a fixed per-tile edge budget per bucket with no sender side (an answer
needs no backward): every graph of a bucket then gets the same layout
shapes, so one captured graph serves the whole bucket. The budget is
``default_edge_budget`` of the bucket's padded sizes, grown to a request's
``required_edge_budget`` when one of its tiles holds more edges (then kept
for the bucket: a new budget is a new capture), as ``train_saint`` does.
(The JAX Predictor runs its XLA convs: its model takes the fused path only
when given a layout.)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ampnet_tpu_torch.core.graph import Graph, from_arrays
from ampnet_tpu_torch.ops.hopper.format import (
    DEFAULT_TILE_NODES,
    EdgeLayout,
    compute_layout,
    default_edge_budget,
    required_edge_budget,
)
from ampnet_tpu_torch.train.checkpoint import load_checkpoint_params
from ampnet_tpu_torch.train.state import make_predict_step


class Predictor:
    """predict(x, edge_index) -> log-probs [N, C] (real nodes only).

    One forward is kept per padded (num_nodes, num_edges) bucket; feed
    graphs of one bucket to keep one capture. ``params``: a state_dict
    copied into ``model`` in place (the model already holds its weights
    when None). The model's device is the Predictor's: the card unless the
    model was made on the CPU."""

    def __init__(
        self,
        model: torch.nn.Module,
        params: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        bucket_nodes: int = 512,
        bucket_edges: int = 4096,
    ):
        self.model = model
        if params is not None:
            model.load_state_dict(params, strict=True)
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.bucket_nodes = bucket_nodes
        self.bucket_edges = bucket_edges
        self.step = make_predict_step(model)
        self._budgets: Dict[Tuple[int, int], int] = {}

    def load_params(self, checkpoint_path: str) -> None:
        """Hot-swap params from a checkpoint (rollover without a new
        capture): copied into the model's parameter tensors in place."""
        self.model.load_state_dict(load_checkpoint_params(checkpoint_path), strict=True)

    def _bucket(self, n: int, e: int) -> Tuple[int, int]:
        bn, be = self.bucket_nodes, self.bucket_edges
        return (-(-n // bn) * bn, -(-e // be) * be)

    def layout(self, graph: Graph) -> Optional[EdgeLayout]:
        """The request's edge layout at its bucket's budget, built from the
        graph where it lies and put on the model's device (None without
        use_pallas: the plain path)."""
        if not self.model.config.use_pallas:
            return None
        shape = (graph.num_nodes_padded, graph.num_edges_padded)
        budget = self._budgets.get(shape) or default_edge_budget(
            shape[1], -(-shape[0] // DEFAULT_TILE_NODES))
        try:
            layout = compute_layout(graph, edges_per_tile=budget, sender_layout=False)
        except ValueError:
            budget = max(budget, required_edge_budget(graph))
            layout = compute_layout(graph, edges_per_tile=budget, sender_layout=False)
        self._budgets[shape] = budget
        return layout.to(self.device)

    def predict_graph(self, graph: Graph,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Log-probs [N_padded, C] of a padded graph, on the model's device;
        the tokens drawn from ``generator``, else from the Predictor's own.
        The layout is built from the graph where it lies: a host graph
        spares reading the edges back from the card."""
        if generator is None:
            generator = self.generator
        layout = self.layout(graph)
        return self.step(graph.to(self.device), generator, layout)

    def predict(
        self,
        x: np.ndarray,
        edge_index: np.ndarray,
        generator: Optional[torch.Generator] = None,
    ) -> np.ndarray:
        """Raw-array entry: pads to the configured bucket, returns
        log-probs for the real nodes."""
        n = x.shape[0]
        pn, pe = self._bucket(n, edge_index.shape[1])
        g = from_arrays(x, edge_index, pad_nodes_to=pn, pad_edges_to=pe)
        logits = self.predict_graph(g, generator)
        return logits[:n].cpu().numpy()
