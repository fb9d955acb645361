"""Communication accounting: all-gather against the boundary-only halo
exchange (``experiments/halo_comm_accounting.py`` in the port).

Two kinds of evidence:

  * ANALYTIC per-rank traffic per AMPConv, from the partition plans
    themselves (host numpy): the all-gather receives (P-1)/P * N_tot rows
    of S*2D f32; the halo receives the true boundary set of each remote
    pair (``pair_counts``), and the padded figure actually moved, the sum
    of the offsets' blocks.
  * MEASURED (``--measured``): the bytes ``parallel/collectives.py`` moves
    in one edge-partitioned training step of the Cora-scale model on P
    spawned ranks (``Mesh.moved``, counted inside each collective), with
    the halo exchange and with the all-gather, beside the analytic figure
    for the same graph and P. The JAX driver reads its measured column
    from the compiled HLO's collectives instead.

Graphs: the Cora-shaped surrogate (N=2708, E=10556) partitioned with no
locality (random edges: the worst cut), and the 1M-edge scale graph
(N=100k, E=1M) with a locality window; P = 2/4/8 (+16/32 on the 1M graph).

    python -m ampnet_tpu_torch.experiments.halo_comm_accounting \\
        [--measured] [--measured-shards 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List

import numpy as np

from ampnet_tpu_torch.core.graph import from_arrays, pad_graph
from ampnet_tpu_torch.parallel import build_halo_plan, partition_graph

S, D = 20, 128             # the reference's main config: tokens/node, embedding
ROW_BYTES = S * 2 * D * 4  # one projected K|V row, f32


def make_graph(n, e, window=None, seed=0):
    rng = np.random.default_rng(seed)
    recv = rng.integers(0, n, e)
    if window:
        send = (recv + rng.integers(-window, window + 1, e)) % n
    else:
        send = rng.integers(0, n, e)
    x = np.zeros((n, 4), np.float32)
    x[:, 0] = 1.0
    return from_arrays(x.astype(np.float32), np.stack([send, recv]),
                       y=np.zeros(n, np.int64),
                       train_mask=np.ones(n, bool),
                       node_norm=np.ones(n, np.float32))


def account(g, p_shards: int) -> Dict[str, Any]:
    """The analytic row of ``g`` over ``p_shards`` ranks."""
    pg = partition_graph(g, p_shards)
    plan = build_halo_plan(pg)
    n_loc = pg.x.shape[1]
    n_tot = n_loc * p_shards
    pc = np.asarray(plan.pair_counts)  # [dst, src]
    # per-rank RECEIVED rows per conv
    allgather_rows = (p_shards - 1) * n_loc
    halo_true_rows = int(pc.sum(axis=1).max())   # worst rank, true cut
    # per-offset exchange: every rank receives each live offset's block
    halo_padded_rows = int(sum(plan.sizes))
    return {
        "P": p_shards,
        "N_tot": n_tot,
        "live_offsets": len(plan.offsets),
        "halo_rows_per_chip": halo_padded_rows,
        "allgather_recv_MB_per_chip_per_conv": round(allgather_rows * ROW_BYTES / 1e6, 1),
        "halo_recv_MB_true": round(halo_true_rows * ROW_BYTES / 1e6, 1),
        "halo_recv_MB_padded": round(halo_padded_rows * ROW_BYTES / 1e6, 1),
        "reduction_x": round(allgather_rows / max(halo_padded_rows, 1), 2),
        "kv_buffer_MB_allgather": round(n_tot * ROW_BYTES / 1e6, 1),
        "kv_buffer_MB_halo": round((n_loc + halo_padded_rows) * ROW_BYTES / 1e6, 1),
    }


def analytic() -> List[Dict[str, Any]]:
    """The table: both graphs, every P."""
    rows = []
    cora = make_graph(2708, 10556)       # random (no locality: the worst case)
    big = make_graph(100_000, 1_000_000, window=4096)   # locality window
    for name, g in (("cora-surrogate(random)", cora), ("1M-edge(window=4096)", big)):
        for p in ((2, 4, 8) if g is cora else (2, 4, 8, 16, 32)):
            r = account(g, p)
            r["graph"] = name
            rows.append(r)
            print(json.dumps(r), flush=True)
    return rows


def cora_scale_graph():
    """The measured step's graph: the Cora-scale random graph with 1433
    sparse features, padded to 4096 nodes / 32768 edges."""
    rng = np.random.default_rng(0)
    n, e, f = 2708, 10556, 1433
    x = (rng.random((n, f)) < 0.02).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    g = from_arrays(x, ei, y=rng.integers(0, 7, n), train_mask=np.ones(n, bool),
                    node_norm=np.ones(n, np.float32))
    return pad_graph(g, 4096, 32768)


def measure_rank(rank: int, n_shards: int, graph, cfg, device="cuda") -> Dict[str, Any]:
    """One rank of the measured steps: one training step of ``cfg`` (no
    dropout) over ``n_shards`` ranks with the halo exchange, then one with
    the all-gather, each from the same seed-0 weights; per step the bytes
    each collective brought this rank, the staged calls, the loss."""
    import torch

    from ampnet_tpu_torch.models import AMPGCN
    from ampnet_tpu_torch.parallel import make_mesh, make_partitioned_train_step
    from ampnet_tpu_torch.parallel.edge_partition import rank_generator
    from ampnet_tpu_torch.train.optim import make_optimizer
    from ampnet_tpu_torch.train.state import TrainState

    mesh = make_mesh(data=1, graph=n_shards, device=device)
    pg = partition_graph(graph, n_shards)
    i = (mesh.index("graph"),)
    out = {"rank": rank}
    for label, use_halo in (("halo", True), ("allgather", False)):
        extra = (build_halo_plan(pg).local(i, mesh.device),) if use_halo else ()
        model = AMPGCN(cfg, device=mesh.device)
        state = TrainState(model, make_optimizer(model.parameters(), 1e-3),
                           rank_generator(0, mesh))
        step = make_partitioned_train_step(model, mesh, loss_mode="full", use_halo=use_halo)
        mesh.moved.clear()
        mesh.staged.clear()
        _, m = step(state, pg.local(i, mesh.device), *extra)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        out[label] = {"moved": dict(mesh.moved), "staged": dict(mesh.staged),
                      "loss": float(m["loss"])}
    return out


def measured(n_shards: int = 8, device="cuda", graph=None, cfg=None) -> Dict[str, Any]:
    """One partitioned step with the halo and one with the all-gather on
    ``n_shards`` spawned ranks (``graph``: the Cora-scale graph; ``cfg``:
    the default model, S=20, D=128, no dropout): per rank the bytes by
    collective, beside the plan's figures for one conv's exchange (the
    padded blocks, S*2D f32 a row; forward and backward alike)."""
    from ampnet_tpu_torch.core.config import AMPGCNConfig
    from ampnet_tpu_torch.parallel.launch import spawn

    graph = cora_scale_graph() if graph is None else graph
    cfg = AMPGCNConfig(dropout_rate=0.0, dropout_adj_rate=0.0) if cfg is None else cfg
    row_bytes = cfg.num_sampled_vectors * 2 * cfg.embedding_dim * 4
    pg = partition_graph(graph, n_shards)
    plan = build_halo_plan(pg)
    ranks = spawn(measure_rank, n_shards, n_shards, graph, cfg, device, device=device)
    out = {"P": n_shards, "nodes_padded": graph.num_nodes_padded,
           "plan_halo_bytes_per_conv": int(sum(plan.sizes)) * row_bytes,
           "plan_allgather_bytes_per_conv": (n_shards - 1) * pg.x.shape[1] * row_bytes,
           "halo": [dict(r["halo"], rank=r["rank"]) for r in ranks],
           "allgather": [dict(r["allgather"], rank=r["rank"]) for r in ranks]}
    print(json.dumps({k: [r["moved"] for r in out[k]] for k in ("halo", "allgather")}),
          flush=True)
    return out


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--measured", action="store_true",
                    help="also count the bytes of one partitioned step on spawned ranks")
    ap.add_argument("--measured-shards", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = {"analytic": analytic()}
    if a.measured:
        out["measured"] = measured(a.measured_shards, a.device)
    return out


if __name__ == "__main__":
    main()
