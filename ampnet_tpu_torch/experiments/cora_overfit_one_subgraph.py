"""Overfit-one-subgraph sanity harness
(``experiments/cora_overfit_one_subgraph.py`` in the port): a deeper
3-layer AMPGCN variant (tokenize -> 3x (AMPConv -> LayerNorm -> ReLU) ->
token mean-pool -> linear head) trained again and again on one GraphSAINT
subgraph of Cora; it must reach ~100% train accuracy. The convs run the
plain path on the card (the JAX model's XLA convs).

    python -m ampnet_tpu_torch.experiments.cora_overfit_one_subgraph [--iters 300] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ampnet_tpu_torch.core.config import TokenizerConfig
from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler
from ampnet_tpu_torch.experiments.common import cora_graph
from ampnet_tpu_torch.models.amp_gcn import LAYER_NORM_EPS, ModelOutput
from ampnet_tpu_torch.models.classifiers import _Classifier, _dense
from ampnet_tpu_torch.models.layers import AMPConv
from ampnet_tpu_torch.models.tokenizer import FeatureTokenizer
from ampnet_tpu_torch.train import create_train_state, make_optimizer, make_train_step


class AMPGCN3(_Classifier):
    """3-layer AMPGCN: tokenize -> 3x (AMPConv -> LayerNorm without scale or
    bias -> ReLU) -> mean-pool -> linear head -> log_softmax. Parameters
    from ``generator`` (seed 0 when None), then moved to ``device``."""

    def __init__(self, embedding_dim: int = 64, num_heads: int = 4,
                 num_node_features: int = 1433, num_sampled_vectors: int = 20,
                 output_dim: int = 7, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self._set_config(embedding_dim=embedding_dim, num_heads=num_heads,
                         num_node_features=num_node_features,
                         num_sampled_vectors=num_sampled_vectors, output_dim=output_dim)
        d = embedding_dim
        self.tokenizer = FeatureTokenizer(TokenizerConfig(
            num_node_features=num_node_features, feat_emb_dim=d - 1, val_emb_dim=1,
            num_sampled_vectors=num_sampled_vectors), generator=generator)
        self.convs = torch.nn.ModuleList(
            AMPConv(d, num_heads, generator=generator) for _ in range(3))
        self.final_linear_out = _dense(d, output_dim, generator)
        self.to(device)

    def forward(self, graph: Graph, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, edge_layout=None,
                return_aux: bool = False, sampled_idx: Optional[torch.Tensor] = None):
        x, _ = self.tokenizer(graph.x, node_mask=graph.node_mask, sampled_idx=sampled_idx,
                              generator=generator)
        for conv in self.convs:
            x, _ = conv(x, graph.senders, graph.receivers, graph.edge_mask,
                        return_weights=False)
            x = torch.relu(F.layer_norm(x, x.shape[-1:], eps=LAYER_NORM_EPS))
        out = torch.log_softmax(self.final_linear_out(x.mean(dim=1)), dim=-1)
        return ModelOutput(out, {}) if return_aux else out


def main(iters: int = 300, device="cuda") -> Dict[str, float]:
    """Train on one subgraph; returns the last step's metrics and the
    losses and accuracies every step."""
    d, _ = cora_graph()
    sampler = GraphSaintRandomWalkSampler(
        d.x, d.edge_index, y=d.y, train_mask=d.train_mask,
        batch_size=1, walk_length=100, num_steps=1, sample_coverage=0, seed=0,
    )
    sub = sampler.sample().to(device)
    model = AMPGCN3(device=device)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-3, grad_clip=1.0),
                               seed=0)
    step = make_train_step(model, loss_mode="full")
    losses, accs = [], []
    for i in range(iters):
        state, metrics = step(state, sub)
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["train_acc"]))
        if i % 50 == 0:
            print(f"iter {i:4d} | loss {losses[-1]:.4f} | train acc {accs[-1]:.4f}")
    print(f"final train acc on one subgraph: {accs[-1]:.4f}")
    return {"loss": losses[-1], "train_acc": accs[-1], "losses": losses, "train_accs": accs,
            "nodes": sub.num_nodes, "edges": sub.num_edges}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.iters, a.device)
