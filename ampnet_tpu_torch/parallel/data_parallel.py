"""Data-parallel training over the mesh's 'data' axis
(``ampnet_tpu/parallel/data_parallel.py`` in torch).

Each rank trains on its own (GraphSAINT) subgraph with the same
parameters; the step averages the ranks' losses, so each rank
differentiates its loss over the number of ranks and the gradients are
summed over 'data' in one flat all-reduce (``collectives.all_reduce_grads``).
As in the JAX package the step passes no layout: the model runs its plain
path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch

from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.parallel.collectives import all_reduce, all_reduce_grads
from ampnet_tpu_torch.parallel.mesh import Mesh
from ampnet_tpu_torch.train.losses import masked_accuracy
from ampnet_tpu_torch.train.state import LOSS_MODES, training_loss


def stack_graphs(graphs: Sequence[Graph]) -> Graph:
    """Stack equally-padded Graphs into one with a leading batch axis."""
    return Graph(**{
        f.name: (None if getattr(graphs[0], f.name) is None
                 else torch.stack([getattr(g, f.name) for g in graphs]))
        for f in dataclasses.fields(Graph)})


def shard_batch(batch: Graph, mesh: Mesh) -> Graph:
    """The rank's graph of a stacked batch (one per data index), on its
    device."""
    i = mesh.index("data")
    return Graph(**{f.name: (None if getattr(batch, f.name) is None
                             else getattr(batch, f.name)[i].to(mesh.device))
                    for f in dataclasses.fields(Graph)})


def make_dp_train_step(
    model: torch.nn.Module,
    mesh: Mesh,
    loss_mode: str = "saint",
) -> Callable[..., Tuple[object, Dict[str, torch.Tensor]]]:
    """step(state, graph) -> (state, metrics): the rank's own graph (or a
    stacked batch, of which it takes its entry) through the model with
    dropout on, its generator the rank's. Loss and train accuracy are the
    means over the data ranks, as the JAX package's mean of shard losses."""
    if loss_mode not in LOSS_MODES:
        raise ValueError(f"unknown loss_mode {loss_mode!r}")
    n = mesh.size("data")

    def step(state, graph: Graph):
        if state.model is not model:
            raise ValueError("the state belongs to another model than this step")
        if graph.x.dim() == 3:
            graph = shard_batch(graph, mesh)
        state.optimizer.zero_grad()
        logits = model(graph, deterministic=False, generator=state.generator)
        loss = training_loss(loss_mode, logits, graph)
        (loss / n).backward()
        all_reduce_grads(model.parameters(), mesh, "data")
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            acc = masked_accuracy(logits, graph.y, graph.train_mask & graph.node_mask)
            both = all_reduce(torch.stack([loss.detach(), acc]), mesh, "data") / n
        return state, {"loss": both[0], "train_acc": both[1]}

    return step
