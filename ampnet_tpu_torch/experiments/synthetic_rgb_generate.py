"""RPG/RGB dataset generator (``experiments/synthetic_rgb_generate.py`` in
the port): train/valid/test splits of random-partition community graphs
with RGB node features, one pickle per split, the same graphs as the JAX
driver's for the same seed. Host only.

    python -m ampnet_tpu_torch.experiments.synthetic_rgb_generate \\
        [-o ./data/synthetic_RGB] [--seed 111]
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List

import numpy as np

from ampnet_tpu_torch.data.synthetic import random_partition_graph, rpg_rgb_features


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Synthetic RGB Random Partition Graph Datasets")
    p.add_argument("-D", "--dataset", type=str, default="Colors")
    p.add_argument("-o", "--out_dir", type=str, default="./data/synthetic_RGB")
    p.add_argument("--RGB_train", type=int, default=100)
    p.add_argument("--RGB_valid", type=int, default=300)
    p.add_argument("--RGB_test", type=int, default=300)
    p.add_argument("--Nodes_min", type=int, default=3)
    p.add_argument("--Nodes_max", type=int, default=10)
    p.add_argument("--Homophily_min", type=float, default=0.5)
    p.add_argument("--Homophily_max", type=float, default=0.9)
    p.add_argument("--Heterophily_min", type=float, default=0.1)
    p.add_argument("--Heterophily_max", type=float, default=0.5)
    p.add_argument("--dim", type=int, default=3)
    p.add_argument("--Max_index", type=int, default=255)
    p.add_argument("--seed", type=int, default=111)
    return p.parse_args(argv)


def generate_split(n_graphs: int, args: argparse.Namespace,
                   rng: np.random.Generator) -> List[Dict[str, np.ndarray]]:
    """``n_graphs`` graphs, each {'adj', 'labels', 'features'}."""
    graphs = []
    for _ in range(n_graphs):
        nv = int(rng.integers(args.Nodes_min, args.Nodes_max + 1))
        hom = rng.uniform(args.Homophily_min, args.Homophily_max)
        het = rng.uniform(args.Heterophily_min, args.Heterophily_max)
        adj, labels = random_partition_graph(args.dim, nv, hom, het, rng)
        feats = rpg_rgb_features(adj, args.dim, nv, args.Max_index)
        graphs.append({"adj": adj, "labels": labels, "features": feats})
    return graphs


def main(argv=None) -> Dict[str, str]:
    """Write the three splits; returns {split: path}."""
    args = parse_args(argv)
    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    paths = {}
    for split, n in [("train", args.RGB_train), ("valid", args.RGB_valid),
                     ("test", args.RGB_test)]:
        graphs = generate_split(n, args, rng)
        paths[split] = os.path.join(args.out_dir, f"{args.dataset}_{split}.pkl")
        with open(paths[split], "wb") as f:
            pickle.dump(graphs, f)
        print(f"wrote {n} graphs -> {paths[split]}")
    return paths


if __name__ == "__main__":
    main()
