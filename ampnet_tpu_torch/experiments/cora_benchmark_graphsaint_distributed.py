"""Data-parallel Cora GraphSAINT training
(``experiments/cora_benchmark_graphsaint_distributed.py`` in the port).

One process per rank over the mesh's 'data' axis
(``parallel.make_dp_train_step``): each rank draws its own GraphSAINT
stream (batch 20, walks of 200, 10 subgraphs an epoch, coverage 50,
padded 4096/32768, seed 100 + rank), the gradients are averaged over the
ranks, Adam lr 1e-3, 30 epochs; then the full graph's test accuracy.
``--tiny`` is the JAX driver's smoke scale (D=16, H=2, S=4, batch 4, walks
of 20, coverage 5, padded 512/2048).

The ranks are started one of two ways: ``main`` spawns them itself
(``parallel.launch.spawn``, ``--shards`` of them, gloo or NCCL by
``mesh.default_backend``), or ``torchrun --nproc-per-node N -m
ampnet_tpu_torch.experiments.cora_benchmark_graphsaint_distributed``
starts them and each runs one rank (the group from torchrun's
environment).

    python -m ampnet_tpu_torch.experiments.cora_benchmark_graphsaint_distributed \\
        --shards 2 --tiny [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List

import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler
from ampnet_tpu_torch.experiments.common import cora_graph
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.parallel import make_dp_train_step, make_mesh
from ampnet_tpu_torch.parallel.edge_partition import rank_generator
from ampnet_tpu_torch.train.optim import make_optimizer
from ampnet_tpu_torch.train.state import TrainState, make_eval_step


def run_rank(rank: int, epochs: int = 30, steps: int = 10, n_shards: int = 2,
             tiny: bool = False, device="cuda") -> Dict[str, Any]:
    """One rank's training; rank 0 prints the epochs and evaluates the
    full graph. Returns the rank's per-step losses and sub-graph
    accuracies (the ranks' means) and, on rank 0, the test accuracy."""
    start = time.time()
    d, full_g = cora_graph()
    mesh = make_mesh(data=n_shards, device=device)
    pad_n, pad_e = (512, 2048) if tiny else (4096, 32768)
    sampler = GraphSaintRandomWalkSampler(
        d.x, d.edge_index, y=d.y,
        train_mask=d.train_mask, val_mask=d.val_mask, test_mask=d.test_mask,
        batch_size=4 if tiny else 20, walk_length=20 if tiny else 200,
        num_steps=steps, sample_coverage=5 if tiny else 50,
        pad_nodes_to=pad_n, pad_edges_to=pad_e, seed=100 + mesh.index("data"))
    cfg = AMPGCNConfig(
        embedding_dim=16 if tiny else 128, num_heads=2 if tiny else 4,
        num_node_features=1433, num_sampled_vectors=4 if tiny else 20, output_dim=7,
        feat_emb_dim=15 if tiny else 127, val_emb_dim=1)
    model = AMPGCN(cfg, device=mesh.device)      # the same seed-0 weights on every rank
    state = TrainState(model, make_optimizer(model.parameters(), 1e-3),
                       rank_generator(0, mesh))
    step = make_dp_train_step(model, mesh, loss_mode="saint")
    losses: List[float] = []
    accs: List[float] = []
    for epoch in range(epochs):
        for sub in sampler:
            state, metrics = step(state, sub.to(mesh.device))
            losses.append(float(metrics["loss"]))
            accs.append(float(metrics["train_acc"]))
        if rank == 0:
            print(f"epoch {epoch:3d} | loss {losses[-1]:.4f} | sub acc {accs[-1]:.4f} | "
                  f"{time.time() - start:.1f}s", flush=True)
    out = {"rank": rank, "losses": losses, "train_accs": accs,
           "seconds": time.time() - start, "staged": dict(mesh.staged)}
    if rank == 0:
        final = make_eval_step(model)(full_g.to(mesh.device),
                                      torch.Generator(device=mesh.device).manual_seed(999))
        out["test_acc"] = float(final["test_acc"])
        print(f"Final Test Accuracy: {out['test_acc']:.4f}", flush=True)
    return out


def main(epochs: int = 30, steps: int = 10, n_shards: int = 2, tiny: bool = False,
         device="cuda") -> List[Dict[str, Any]]:
    """Spawn ``n_shards`` ranks and train; the ranks' results by rank."""
    from ampnet_tpu_torch.parallel.launch import spawn

    return spawn(run_rank, n_shards, epochs, steps, n_shards, tiny, device, device=device)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--shards", type=int, default=2)
    p.add_argument("--tiny", action="store_true", help="smoke-scale config")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    if "TORCHELASTIC_RUN_ID" in os.environ:      # under torchrun: this process is one rank
        from ampnet_tpu_torch.parallel.mesh import initialize_distributed

        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        initialize_distributed(None, world, rank, device=a.device)
        run_rank(rank, a.epochs, a.steps, world, a.tiny, a.device)
        torch.distributed.destroy_process_group()
    else:
        main(a.epochs, a.steps, a.shards, a.tiny, a.device)
