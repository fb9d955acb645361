"""Attention coefficients on Cora (``experiments/visualize_cora_attn_coeffs.py``
in the port): load a checkpoint, run one deterministic full-graph forward,
and draw per class pair the mean attention between the two classes' 30
most present features (heatmaps and clustermaps, with the raw .npy). The
attention weights and sampled feature indices are the forward's aux
outputs. The flags must match the checkpoint's model.

    python -m ampnet_tpu_torch.experiments.visualize_cora_attn_coeffs \\
        --checkpoint runs/<run>/checkpoint_final.pkl --stabilized --raw-residual gcn2
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.data.planetoid import PlanetoidData
from ampnet_tpu_torch.experiments.common import cora_graph
from ampnet_tpu_torch.interpret.attention import visualize_attention_coefficients
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train import load_checkpoint_params

CLASS_PAIRS = ((0, 0), (3, 3), (0, 3))


def build_model(data: PlanetoidData, stabilized: bool = False, raw_residual: str = "",
                checkpoint_path: Optional[str] = None, device="cuda") -> AMPGCN:
    """The model the flags name (stabilized: tfidf S=40 with the dataset's
    scaler; ``raw_residual``: '' | 'mlp' | 'gcn' | 'gcn2'), its parameters
    from ``checkpoint_path`` when given."""
    cfg = AMPGCNConfig(
        embedding_dim=128, num_heads=4, num_node_features=1433,
        num_sampled_vectors=40 if stabilized else 20,
        output_dim=7, feat_emb_dim=127, val_emb_dim=1,
        token_sampling="tfidf" if stabilized else "uniform",
        scaler="precomputed" if stabilized else "batch",
        raw_residual=raw_residual or False,
    )
    model = AMPGCN(cfg, scaler_stats=fit_scaler(data.x) if stabilized else None,
                   device=device)
    if checkpoint_path:
        model.load_state_dict(load_checkpoint_params(checkpoint_path))
    return model


@torch.no_grad()
def attention_inputs(model: AMPGCN, graph: Graph,
                     sampled_idx: Optional[torch.Tensor] = None,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """One deterministic forward on ``graph`` (its tokens drawn from a
    generator seeded ``seed``, unless ``sampled_idx``): the arrays the
    heatmaps read, the PADDED x and y (node and edge arrays index one node
    space; the all-zero pad rows add nothing to the feature counts)."""
    device = next(model.parameters()).device
    graph = graph.to(device)
    out = model(graph, sampled_idx=sampled_idx, return_aux=True,
                generator=torch.Generator(device=device).manual_seed(seed))
    arrays = dict(x=graph.x, y=graph.y, senders=graph.senders, receivers=graph.receivers,
                  edge_mask=graph.edge_mask, attn_weights=out.aux["attn_weights_1"],
                  sampled_idx=out.aux["sampled_idx"])
    return {k: v.detach().cpu().numpy() for k, v in arrays.items()}


def main(checkpoint_path: Optional[str] = None, save_path: str = "attn_coeff_plots",
         class_pairs=CLASS_PAIRS, stabilized: bool = False, raw_residual: str = "",
         device="cuda"):
    d, g = cora_graph()
    model = build_model(d, stabilized, raw_residual, checkpoint_path, device)
    heatmaps = visualize_attention_coefficients(
        **attention_inputs(model, g), save_path=save_path, class_pairs=list(class_pairs))
    print(f"saved {len(heatmaps)} heatmaps to {save_path}")
    return heatmaps


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--stabilized", action="store_true",
                   help="model flags of the stabilized recipe (tfidf S=40, "
                        "precomputed scaler): must match the checkpoint")
    p.add_argument("--raw-residual", default="",
                   help="'' | mlp | gcn | gcn2: must match the checkpoint")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="attn_coeff_plots")
    a = p.parse_args()
    main(a.checkpoint, a.out, stabilized=a.stabilized, raw_residual=a.raw_residual,
         device=a.device)
