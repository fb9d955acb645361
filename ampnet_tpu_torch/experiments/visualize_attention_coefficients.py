"""XOR attention-coefficient visualization
(``experiments/visualize_attention_coefficients.py`` in the port): forward
the XOR model (fresh, or from a checkpoint) on the XOR training graph,
bucket the edges by (src quadrant, dst quadrant) of the truth table and
histogram the per-edge attention entries
(``interpret.plot_xor_attn_weights``). ``attention_weights`` computes the
numbers (on the card by default); ``main`` also draws, importing the
drawing libraries only then.

    python -m ampnet_tpu_torch.experiments.visualize_attention_coefficients \\
        [--checkpoint PATH] [--no-softmax] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.data.synthetic import get_xor_graphs
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.train.checkpoint import load_checkpoint_params


def attention_weights(checkpoint_path: Optional[str] = None, softmax_attn: bool = True,
                      device="cuda") -> Tuple[Graph, np.ndarray]:
    """(the XOR training graph on the CPU, the first conv's head-averaged
    attention weights [E, S, S] as numpy)."""
    train_g, _ = get_xor_graphs(400, 64, 0.3, seed=0)
    cfg = AMPGCNConfig(
        embedding_dim=16, num_heads=2, num_node_features=2,
        num_sampled_vectors=8, output_dim=2, feat_emb_dim=15, val_emb_dim=1,
        dropout_rate=0.0, dropout_adj_rate=0.0, attn_softmax=softmax_attn)
    model = AMPGCN(cfg, device=device)
    if checkpoint_path:
        model.load_state_dict(load_checkpoint_params(checkpoint_path))
    dev = next(model.parameters()).device
    with torch.no_grad():
        out = model(train_g.to(dev), deterministic=True, return_aux=True,
                    generator=torch.Generator(device=dev).manual_seed(0))
    return train_g, out.aux["attn_weights_1"].cpu().numpy()


def main(checkpoint_path: Optional[str] = None, save_path: str = "xor_attn_plots",
         softmax_attn: bool = True, device="cuda") -> str:
    from ampnet_tpu_torch.interpret.attention import plot_xor_attn_weights

    g, weights = attention_weights(checkpoint_path, softmax_attn, device)
    # no-softmax weights are unbounded: the reference's wide bins
    bins = (-7.5, 7.5) if not softmax_attn else (0.0, 1.0)
    path = plot_xor_attn_weights(
        x=g.x.numpy(), y=g.y.numpy(), senders=g.senders.numpy(),
        receivers=g.receivers.numpy(), edge_mask=g.edge_mask.numpy(),
        attn_weights=weights, save_path=save_path, bins=bins)
    print("saved", path)
    return path


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--no-softmax", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.checkpoint, softmax_attn=not a.no_softmax, device=a.device)
