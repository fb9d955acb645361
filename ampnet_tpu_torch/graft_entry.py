"""The single-device entry point (``__graft_entry__.py::entry`` in the port).

``entry()`` -> (fn, example_args): the flagship AMPGCN's forward as the
port's predict step, fn(graph, generator) -> log-probs [768, 7], one
captured CUDA graph on the card (``train/state.py::make_predict_step``).
The flagship is ``AMPGCNConfig()``'s defaults (D=128, H=4, S=20: the
reference's main config) on a Cora-subgraph-shaped random graph: 768
nodes, 4,096 edges, 1,433 features, drawn from ``np.random.default_rng(0)``
as the JAX entry draws it. The defaults run the plain path
(``use_pallas=False``), so the entry launches no hand-written kernel, as
the JAX entry runs XLA's. ``fn.model`` is the model (its parameters are
what fn computes with).

``dryrun_multichip(n)`` spawns n ranks of one process group as a
('data' x 'graph') mesh (``parallel.auto_mesh_shape``) and runs ONE step of
the combined data-parallel + edge-partitioned training step with the
boundary-only halo exchange (``parallel.make_dp_partitioned_train_step``),
each shard's convs through the fused kernels (K1 forward, K3 + K4
backward). On the card it runs the JAX dry run's "cora" scale (the
flagship's graph drawn at 4,096 nodes / 32,768 edges, D=128, H=4, S=20,
so that every shard holds real nodes and the halo is not empty), every
rank on ``cuda:(rank % device count)`` (several gloo ranks share one card);
with ``device="cpu"`` the "tiny" flagship through the kernels' plain
versions.

    python -m ampnet_tpu_torch.graft_entry [n]
    python -c "from ampnet_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(4)"
"""
from __future__ import annotations

import os
import sys
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import Graph, from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.train.state import make_predict_step


def _flagship(scale: str = "entry", device="cuda") -> Tuple[AMPGCN, AMPGCNConfig, Graph]:
    """(model, config, graph on ``device``): the JAX entry's graph from the
    same draws; the model's weights from the port's seed-0 generator.
    ``scale``: 'entry' (768 nodes, 4,096 edges), 'cora' (the multi-rank dry
    run's 4,096 / 32,768, drawn the same way) or 'tiny' (the JAX dry run's
    small config and 32-node graph)."""
    if scale == "tiny":
        cfg = AMPGCNConfig(
            embedding_dim=16, num_heads=2, num_node_features=32,
            num_sampled_vectors=4, output_dim=7, feat_emb_dim=15, val_emb_dim=1,
            dropout_rate=0.0, dropout_adj_rate=0.0)
        n, e, f = 32, 128, 32
    else:
        # Cora GraphSAINT-subgraph shapes with the reference's main config
        cfg = AMPGCNConfig()
        n, e, f = (4096, 32768, 1433) if scale == "cora" else (768, 4096, 1433)

    rng = np.random.default_rng(0)
    x = (rng.random((n, f)) < 0.02).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    y = rng.integers(0, cfg.output_dim, n)
    g = from_arrays(x, ei, y=y, train_mask=np.ones(n, bool),
                    node_norm=np.ones(n, np.float32))
    return AMPGCN(cfg, device=device), cfg, g.to(device)


def entry(device="cuda") -> Tuple[Callable[..., torch.Tensor], tuple]:
    """The flagship forward + its example args (graph, generator)."""
    model, _cfg, g = _flagship(device=device)
    step = make_predict_step(model)

    def forward(graph: Graph, generator: torch.Generator) -> torch.Tensor:
        return step(graph, generator)

    forward.model = model
    return forward, (g, torch.Generator(device=g.x.device).manual_seed(0))


def _dryrun_rank(rank: int, n_devices: int, scale: str, device) -> dict:
    """One rank of the dry run: its report (loss, accuracy, launches, the
    halo's rows per offset, its K|V and query rows, the staged
    collectives)."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.parallel import (
        auto_mesh_shape, build_halo_plan, common_halo_meta, make_dp_partitioned_train_step,
        make_mesh, partition_graph, partition_layouts, stack_halos, stack_layouts,
        stack_partitioned)
    from ampnet_tpu_torch.parallel.edge_partition import rank_generator
    from ampnet_tpu_torch.train.optim import make_optimizer
    from ampnet_tpu_torch.train.state import TrainState

    tiny = scale != "cora"
    data, graph_shards = auto_mesh_shape(n_devices)
    mesh = make_mesh(data=data, graph=graph_shards, device=device)
    # the cora scale's shapes (the JAX dry run pads the 768-node flagship to
    # 4,096 / 32,768, which leaves every real node on graph shard 0 and the
    # halo empty): here as many real nodes and edges, drawn the same way
    model, _cfg, g = _flagship("tiny" if tiny else "cora", device="cpu")
    model.to(mesh.device)
    pgs = [partition_graph(g, graph_shards) for _ in range(data)]
    batch = stack_partitioned(pgs)
    meta = common_halo_meta(pgs)
    plans = [build_halo_plan(pg, force_meta=meta) for pg in pgs]
    tile_nodes = 8 if tiny else 64
    layouts = stack_layouts([partition_layouts(pg, tile_nodes=tile_nodes,
                                               edges_per_tile=128 if tiny else 0,
                                               halo_plan=pl)
                             for pg, pl in zip(pgs, plans)])
    halo = stack_halos(plans)
    opt = make_optimizer(model.parameters(), 1e-3, weight_decay=1e-4, grad_clip=1.0)
    state = TrainState(model, opt, rank_generator(0, mesh))
    step = make_dp_partitioned_train_step(model, mesh, loss_mode="saint", use_pallas=True,
                                          tile_nodes=tile_nodes, use_halo=True)
    index = (mesh.index("data"), mesh.index("graph"))
    local = (batch.local(index, mesh.device), layouts.local(index, mesh.device),
             halo.local(index, mesh.device))
    eaf.reset_launch_counts()
    t0 = time.perf_counter()
    _, metrics = step(state, *local)
    loss, acc = float(metrics["loss"]), float(metrics["train_acc"])
    seconds = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite loss in the multi-rank dry run: {loss}")
    n_loc = batch.x.shape[2]
    return {"rank": rank, "data": mesh.index("data"), "graph": mesh.index("graph"),
            "mesh": dict(mesh.shape), "backend": mesh.backend, "device": str(mesh.device),
            "loss": loss, "train_acc": acc, "step_s": seconds,
            "n_loc": n_loc, "n_all": n_loc + halo.halo_width,
            "halo_offsets": list(halo.offsets), "halo_rows": list(halo.sizes),
            "pair_rows": halo.pair_counts[index].tolist(),
            "launches": eaf.launch_counts(), "body_launches": eaf.body_launch_counts(),
            "staged": dict(mesh.staged)}


def dryrun_multichip(n_devices: int, scale: Optional[str] = None,
                     device=None) -> List[dict]:
    """Spawn ``n_devices`` ranks, build their ('data' x 'graph') mesh
    (``auto_mesh_shape``) and run ONE step of the data-parallel +
    edge-partitioned training step with the halo exchange and the fused
    kernels per shard. ``scale`` 'cora' (the default on the card) or
    'tiny' (the default with ``device="cpu"``); env override
    ``AMPNET_DRYRUN_SCALE``. Returns the ranks' reports; a rank that fails
    (a non-finite loss too) makes the call raise."""
    from ampnet_tpu_torch.parallel.launch import spawn
    from ampnet_tpu_torch.parallel.mesh import auto_mesh_shape

    device = "cuda" if device is None else device
    if scale is None:
        scale = os.environ.get("AMPNET_DRYRUN_SCALE",
                               "cora" if torch.device(device).type == "cuda" else "tiny")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device (pass device='cpu' for the CPU)")
    t0 = time.time()
    reports = spawn(_dryrun_rank, n_devices, n_devices, scale, device, device=device)
    data, graph_shards = auto_mesh_shape(n_devices)
    print(f"dryrun_multichip OK ({scale}): mesh data={data} x graph={graph_shards}, "
          f"loss={reports[0]['loss']:.4f}, train_acc={reports[0]['train_acc']:.4f}, "
          f"{time.time() - t0:.1f}s incl. start-up")
    return reports


if __name__ == "__main__":
    fn, args = entry()
    print("entry OK:", tuple(fn(*args).shape))
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
