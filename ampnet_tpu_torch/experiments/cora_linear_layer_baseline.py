"""Linear-probe floor baseline on Cora
(``experiments/cora_linear_layer_baseline.py`` in the port): the PCA
feature embedding, mask-token downsampling (a balanced draw of 40
features keeps its tokens per node) and one linear layer over the
flattened tokens, trained on GraphSAINT subgraphs; final test accuracy
on the full graph. No attention: no kernel of the port runs.

    python -m ampnet_tpu_torch.experiments.cora_linear_layer_baseline [--epochs 10] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler
from ampnet_tpu_torch.experiments.common import cora_graph
from ampnet_tpu_torch.models.amp_gcn import ModelOutput
from ampnet_tpu_torch.models.classifiers import _Classifier, _dense
from ampnet_tpu_torch.ops.tokenize import balanced_sample_features, pca_feature_embedding
from ampnet_tpu_torch.train import create_train_state, make_eval_step, make_train_step
from ampnet_tpu_torch.train.optim import make_optimizer


class LinearLayerModel(_Classifier):
    """PCA-embed + mask-token sampling + linear head. ``pca_embedding``
    [F, feat_emb_dim]: a constant buffer. Per node, a balanced draw of
    ``num_sampled_vectors`` features keeps its tokens (PCA row | raw
    value); every other token is the learned mask token; the flattened
    tokens are z-scored over the whole tensor, then one linear layer ->
    log_softmax."""

    def __init__(self, pca_embedding, num_node_features: int = 1433,
                 num_sampled_vectors: int = 40, feat_emb_dim: int = 99, val_emb_dim: int = 1,
                 output_dim: int = 7, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self._set_config(num_node_features=num_node_features,
                         num_sampled_vectors=num_sampled_vectors, feat_emb_dim=feat_emb_dim,
                         val_emb_dim=val_emb_dim, output_dim=output_dim)
        self.num_sampled_vectors = num_sampled_vectors
        emb_dim = feat_emb_dim + val_emb_dim
        self.register_buffer("pca_embedding", torch.as_tensor(
            np.asarray(pca_embedding), dtype=torch.float32), persistent=False)
        self.mask_token = torch.nn.Parameter(torch.empty(1, emb_dim))
        with torch.no_grad():
            self.mask_token.normal_(0.0, 0.02, generator=generator)
        self.lin = _dense(num_node_features * emb_dim, output_dim, generator)
        self.to(device)

    def forward(self, graph: Graph, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, edge_layout=None,
                return_aux: bool = False, sampled_idx: Optional[torch.Tensor] = None):
        x = graph.x
        n, f = x.shape
        table = self.pca_embedding
        tokens = torch.cat([table[None].expand(n, f, table.shape[1]), x[..., None]], dim=-1)
        if sampled_idx is None:
            sampled_idx = balanced_sample_features(x, self.num_sampled_vectors,
                                                   generator=generator)
        keep = torch.zeros((n, f), dtype=torch.bool, device=x.device)
        keep = keep.scatter(1, sampled_idx.long(), True)
        tokens = torch.where(keep[..., None], tokens, self.mask_token[None])
        flat = tokens.reshape(n, -1)
        flat = (flat - flat.mean()) / flat.std(unbiased=False).clamp_min(1e-12)
        out = torch.log_softmax(self.lin(flat), dim=-1)
        return ModelOutput(out, {"sampled_idx": sampled_idx}) if return_aux else out


def main(epochs: int = 10, steps: int = 50, device="cuda") -> Dict[str, float]:
    """Train; the full graph's metrics of one draw (a generator seeded 9)
    and the last step's loss of each epoch."""
    d, full_g = cora_graph()
    pca = pca_feature_embedding(d.x, 99)
    sampler = GraphSaintRandomWalkSampler(
        d.x, d.edge_index, y=d.y,
        train_mask=d.train_mask, val_mask=d.val_mask, test_mask=d.test_mask,
        batch_size=8, walk_length=150, num_steps=steps, sample_coverage=20, seed=0,
    )
    model = LinearLayerModel(pca, device=device)
    # the JAX driver initializes on one sampled subgraph: the stream moves on
    sampler.sample()
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-2,
                                                     weight_decay=1e-4), seed=0)
    step = make_train_step(model, loss_mode="saint")
    eval_step = make_eval_step(model)
    losses = []
    for epoch in range(epochs):
        for sub in sampler:
            state, metrics = step(state, sub.to(device))
        losses.append(float(metrics["loss"]))
        print(f"epoch {epoch:3d} | loss {losses[-1]:.4f}")
    g = full_g.to(device)
    final = {k: float(v) for k, v in
             eval_step(g, torch.Generator(device=g.x.device).manual_seed(9)).items()}
    print(f"Final Test Accuracy (linear probe): {final['test_acc']:.4f}")
    return dict(final, epoch_losses=losses)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.epochs, device=a.device)
