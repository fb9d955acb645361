"""Edge-partitioned scaling benchmark (``experiments/scaling_bench.py`` in
the port): ms per step and edges/s of the edge-partitioned AMPGCN training
step at 1, 2, 4, 8 ranks (up to ``--max-shards``), each rank a process of
a group started by ``parallel.launch.spawn``.

On one card every rank shares it (gloo; the halo exchange staged through
host memory), so the edges/s say whether the partitioned step runs and
what the ranks cost together, not how it scales: the JSON says so
(``ranks_share_one_card``). Where each rank has a card of its own the
same numbers are the scaling efficiency. The convs run the plain path
(the JAX driver leaves ``use_pallas`` off).

    python -m ampnet_tpu_torch.experiments.scaling_bench [--max-shards 8] \\
        [--halo] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.parallel import (
    build_halo_plan,
    make_mesh,
    make_partitioned_train_step,
    partition_graph,
)
from ampnet_tpu_torch.parallel.edge_partition import rank_generator
from ampnet_tpu_torch.train.optim import make_optimizer
from ampnet_tpu_torch.train.state import TrainState


def bench_graph(n: int = 512, e: int = 4096, f: int = 256):
    rng = np.random.default_rng(0)
    x = (rng.random((n, f)) < 0.05).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    return from_arrays(x, ei, y=rng.integers(0, 7, n), train_mask=np.ones(n, bool),
                       node_norm=np.ones(n, np.float32))


def bench_config(f: int = 256) -> AMPGCNConfig:
    return AMPGCNConfig(
        embedding_dim=32, num_heads=4, num_node_features=f,
        num_sampled_vectors=8, output_dim=7, feat_emb_dim=31, val_emb_dim=1,
        dropout_rate=0.0, dropout_adj_rate=0.0,
    )


def bench_rank(rank: int, n_shards: int, n: int, e: int, use_halo: bool, iters: int,
               device="cuda") -> Dict[str, Any]:
    """One rank: a first step, then ``iters`` steps timed (the rank's
    device synchronized at both ends). Every rank starts from the same
    seed-0 weights."""
    mesh = make_mesh(data=1, graph=n_shards, device=device)
    g = bench_graph(n, e)
    pg = partition_graph(g, n_shards)
    i = (mesh.index("graph"),)
    extra = (build_halo_plan(pg).local(i, mesh.device),) if use_halo else ()
    shard = pg.local(i, mesh.device)
    model = AMPGCN(bench_config(), device=mesh.device)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-3), rank_generator(0, mesh))
    step = make_partitioned_train_step(model, mesh, loss_mode="full", use_halo=use_halo)
    step(state, shard, *extra)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    sync()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        _, m = step(state, shard, *extra)
    sync()
    dt = (time.perf_counter() - t0) / iters
    return {"rank": rank, "step_s": dt, "loss": float(m["loss"]), "device": str(mesh.device),
            "backend": mesh.backend, "staged": dict(mesh.staged)}


def main(max_shards: int = 8, n: int = 512, e: int = 4096, use_halo: bool = False,
         iters: int = 10, device="cuda") -> Dict[str, Any]:
    """Each shard count's ms per step (the slowest rank's) and edges/s,
    and the scaling efficiency against one rank."""
    from ampnet_tpu_torch.parallel.launch import spawn

    cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
    results = {}
    for s in (c for c in (1, 2, 4, 8) if c <= max_shards):
        ranks = spawn(bench_rank, s, s, n, e, use_halo, iters, device, device=device)
        dt = max(r["step_s"] for r in ranks)
        results[s] = {"step_ms": dt * 1e3, "edges_per_s": e / dt,
                      "ranks_share_one_card": torch.device(device).type == "cuda" and s > cards,
                      "backend": ranks[0]["backend"], "staged": ranks[0]["staged"],
                      "loss": ranks[0]["loss"]}
        print(f"shards={s}: {dt*1e3:.2f} ms/step, {e/dt:.0f} edges/s")
    if 1 in results:
        base = results[1]["edges_per_s"]
        for s in list(results)[1:]:
            eff = results[s]["edges_per_s"] / (base * s)
            results[s]["scaling_efficiency"] = eff
            print(f"shards={s}: scaling efficiency {eff:.2%}")
    print(json.dumps({str(k): v for k, v in results.items()}))
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--max-shards", type=int, default=8)
    p.add_argument("--halo", action="store_true",
                   help="boundary-only halo exchange (the scale-out default) instead of "
                        "the all-gather path")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.max_shards, use_halo=a.halo, device=a.device)
