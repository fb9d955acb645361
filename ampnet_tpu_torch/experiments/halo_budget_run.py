"""An edge-partitioned loss-and-gradient step on a graph whose replicated
projected K|V would be a card's worth of memory
(``experiments/halo_budget_run.py`` in the port).

Shapes: N_tot = 1,048,576 nodes, S=20 tokens, D=128 (the reference's main
config): the projected K|V of every node is N_tot * S * 2D * 4 B = 20 GiB,
which the all-gather exchange would hold on every rank at any rank count.
The boundary-only halo holds N_loc + sum(H_o) rows a rank. Edges have a
locality window (the regime partitioning exists for). One training step
(``make_partitioned_train_step``, the halo exchange, the convs recomputed
in the backward: ``remat=True``; the plain convs, as the JAX driver's)
on ``--shards`` spawned ranks; ``--fwd-only`` runs the forward alone.
With remat the plain halo step runs ``edge_partition._LeanHaloConv``, so
a rank's peak stays near its halo K|V buffer (about 3.6x on an H100): at
the JAX shape both ranks fit one 80 GB card.

The budget is the card's own memory (``torch.cuda.get_device_properties``),
reported beside the two buffers (``budget_gb``, ``replicated_kv_gb``,
``halo_kv_gb``, ``over_budget``) and not asserted: on an 80 GB card the
replicated buffer fits. Every rank reports its step's seconds, its peak
device memory (the line's ``peak_gb``: the largest), the seconds spent in
each collective (each synchronized around itself) and the bytes each
moved.

    python -m ampnet_tpu_torch.experiments.halo_budget_run [--nodes N] [--edges E] \\
        [--window W] [--shards P] [--fwd-only] [--device cpu]
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
    amp_gcn_forward_local,
    build_halo_plan,
    make_mesh,
    make_partitioned_train_step,
    partition_graph,
)
from ampnet_tpu_torch.parallel.edge_partition import rank_generator
from ampnet_tpu_torch.train.optim import make_optimizer
from ampnet_tpu_torch.train.state import TrainState

S, D = 20, 128


def kv_gb(rows: int) -> float:
    """GiB of ``rows`` projected K|V rows (S x 2D f32)."""
    return rows * S * 2 * D * 4 / 2**30


def budget_graph(n: int, e: int, window: int, f: int):
    rng = np.random.default_rng(0)
    recv = rng.integers(0, n, e)
    send = (recv + rng.integers(-window, window + 1, e)) % n
    x = (rng.random((n, f)) < 0.05).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    return from_arrays(x, np.stack([send, recv]), y=rng.integers(0, 7, n),
                       train_mask=np.ones(n, bool), node_norm=np.ones(n, np.float32))


def budget_config(f: int) -> AMPGCNConfig:
    return AMPGCNConfig(
        embedding_dim=D, num_heads=4, num_node_features=f,
        num_sampled_vectors=S, output_dim=7, feat_emb_dim=D - 1, val_emb_dim=1,
        dropout_rate=0.0, dropout_adj_rate=0.0,
    )


def budget_rank(rank: int, n: int, e: int, window: int, f: int, n_shards: int,
                fwd_only: bool, device="cuda") -> Dict[str, Any]:
    """One rank: its shard of the graph (each rank builds the graph from
    the seed and partitions it), one step or forward, timed."""
    t0 = time.time()
    mesh = make_mesh(data=1, graph=n_shards, device=device)
    pg = partition_graph(budget_graph(n, e, window, f), n_shards)
    plan = build_halo_plan(pg)
    i = (mesh.index("graph"),)
    shard, halo = pg.local(i, mesh.device), plan.local(i, mesh.device)
    out = {"rank": rank, "n_loc": pg.x.shape[1], "halo_width": plan.halo_width,
           "halo_offsets": list(plan.offsets), "prepare_s": time.time() - t0}
    del pg
    on_card = mesh.device.type == "cuda"
    model = AMPGCN(budget_config(f), device=mesh.device)
    gen = rank_generator(0, mesh)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    torch.distributed.barrier()
    mesh.spans = {}
    t0 = time.time()
    if fwd_only:
        with torch.no_grad():
            logp = amp_gcn_forward_local(model, shard, mesh, halo=halo, generator=gen)
        out["ok"] = bool(torch.isfinite(logp).all())
    else:
        state = TrainState(model, make_optimizer(model.parameters(), 1e-3), gen)
        step = make_partitioned_train_step(model, mesh, loss_mode="full", use_halo=True,
                                           remat=True)
        _, m = step(state, shard, halo)
        out["loss"] = float(m["loss"])
        out["ok"] = bool(np.isfinite(out["loss"]))
    if on_card:
        torch.cuda.synchronize()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out.update(seconds=time.time() - t0, spans=dict(mesh.spans), moved=dict(mesh.moved),
               staged=dict(mesh.staged), backend=mesh.backend)
    return out


def run(nodes: int = 1_048_576, edges: int = 262_144, window: int = 8192,
        features: int = 128, fwd_only: bool = False, shards: int = 2,
        device="cuda") -> Dict[str, Any]:
    """The buffers' sizes against the card's memory, then the ranks' run."""
    from ampnet_tpu_torch.parallel.launch import spawn

    on_card = torch.device(device).type == "cuda"
    budget = (torch.cuda.get_device_properties(0).total_memory / 2**30 if on_card else None)
    repl = kv_gb(nodes)
    ranks = spawn(budget_rank, shards, nodes, edges, window, features, shards, fwd_only,
                  device, device=device)
    r0 = ranks[0]
    halo = kv_gb(r0["n_loc"] + r0["halo_width"])
    result = dict(
        shards=shards, n_tot=nodes, edges=edges, window=window, S=S, D=D,
        budget_gb=budget, replicated_kv_gb=repl, halo_kv_gb=halo,
        over_budget=None if budget is None else repl > budget,
        n_loc=r0["n_loc"], halo_width=r0["halo_width"],
        mode="fwd-only" if fwd_only else "loss+grad step",
        seconds=max(r["seconds"] for r in ranks),
        peak_gb=max(r["peak_gb"] for r in ranks) if on_card else None,
        exchange_share=max(sum(v for k, v in r["spans"].items() if k.startswith("halo"))
                           / r["seconds"] for r in ranks),
        ok=all(r["ok"] for r in ranks), ranks=ranks)
    if not fwd_only:
        result["loss"] = r0["loss"]
    print(f"replicated K/V would be {repl:.1f} GiB a rank (budget "
          f"{'unknown' if budget is None else f'{budget:.1f} GiB'}); the halo holds "
          f"{halo:.2f} GiB ({repl / halo:.1f}x less)", flush=True)
    print(json.dumps({k: v for k, v in result.items() if k != "ranks"}))
    return result


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=1_048_576)
    ap.add_argument("--edges", type=int, default=262_144)
    ap.add_argument("--window", type=int, default=8192)
    ap.add_argument("--features", type=int, default=128)
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return run(a.nodes, a.edges, a.window, a.features, a.fwd_only, a.shards, a.device)


if __name__ == "__main__":
    main()
