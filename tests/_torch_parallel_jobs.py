"""The ranks' side of tests/test_torch_distributed.py: module-level
functions that ``ampnet_tpu_torch.parallel.launch.spawn`` runs in each rank
of a gloo group on the CPU. Imports torch and the port only (no jax), so
that a rank starts in seconds. Each returns numpy arrays and floats; the
test module holds them against the JAX package."""
from __future__ import annotations

import torch

from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.parallel import (
    amp_gcn_forward_local,
    build_halo_plan,
    common_halo_meta,
    data_sharded,
    make_dp_partitioned_train_step,
    make_dp_tp_train_step,
    make_dp_train_step,
    make_mesh,
    make_partitioned_train_step,
    make_tp_train_step,
    partition_graph,
    partition_layouts,
    stack_halos,
    stack_layouts,
    stack_partitioned,
)
from ampnet_tpu_torch.parallel.head_parallel import amp_gcn_forward_heads, tp_shard_model
from ampnet_tpu_torch.train.state import TrainState

TILE = 4


def graph(arrays):
    return from_arrays(**arrays)


def model_of(cfg, state, stats, device="cpu"):
    model = AMPGCN(cfg, scaler_stats=stats, device=device)
    model.load_state_dict(state)
    return model


def sgd_state(model, lr):
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=lr),
                      torch.Generator().manual_seed(0))


def params_of(model):
    return {k: v.detach().numpy().copy() for k, v in model.named_parameters()}


def grads_of(model):
    return {k: v.grad.detach().numpy().copy() for k, v in model.named_parameters()}


def saved_for_backward(model, shard, mesh, halo, idx, remat):
    """The tensors autograd keeps between the plain partitioned forward
    (the halo exchange) and its backward, one entry per distinct tensor:
    (shape, bytes)."""
    kept = {}

    def pack(t):
        kept[(t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape))] = (
            tuple(t.shape), t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        amp_gcn_forward_local(model, shard, mesh, halo=halo, remat=remat, sampled_idx=idx)
    return list(kept.values())


def two_ranks(rank, inp):
    """graph=2: the partitioned forward (halo and all-gather, plain and
    through the fused op) and one partitioned SGD step (halo, plain and
    fused); data=2: one DP step; heads=2: the TP forward and one TP step."""
    out = {}
    cfg, state, stats, lr = inp["cfg"], inp["state"], inp["stats"], inp["lr"]
    g = graph(inp["graph"])
    pg = partition_graph(g, 2)
    plan = build_halo_plan(pg)
    mesh = make_mesh(graph=2, device="cpu")
    i = (mesh.index("graph"),)
    shard = pg.local(i, "cpu")
    idx = torch.from_numpy(inp["part_idx"][i])
    lay_halo = partition_layouts(pg, tile_nodes=TILE, halo_plan=plan)
    lay_all = partition_layouts(pg, tile_nodes=TILE)
    model = model_of(cfg, state, stats)
    with torch.no_grad():
        for name, layout, halo in (("halo", None, plan), ("allgather", None, None),
                                   ("halo_fused", lay_halo, plan),
                                   ("allgather_fused", lay_all, None)):
            out[f"fwd_{name}"] = amp_gcn_forward_local(
                model, shard, mesh, layout=None if layout is None else layout.local(i, "cpu"),
                tile_nodes=TILE, halo=None if halo is None else halo.local(i, "cpu"),
                sampled_idx=idx).numpy()
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.parallel import edge_partition as ep

    # the lean conv (plain_remat) in chunks of 3 node or edge rows
    ep.LEAN_CHUNK_BYTES = 3 * cfg.num_sampled_vectors * 2 * cfg.embedding_dim * 4
    for name, use_pallas, scatterfree, remat in (("plain", False, True, False),
                                                 ("plain_remat", False, True, True),
                                                 ("fused", True, True, False),
                                                 ("fused_stream", True, False, False),
                                                 ("fused_remat", True, True, True)):
        eaf.SCATTERFREE_BWD_DEFAULT = scatterfree
        model = model_of(cfg, state, stats)
        st = sgd_state(model, lr)
        step = make_partitioned_train_step(model, mesh, loss_mode="full",
                                           use_pallas=use_pallas, tile_nodes=TILE,
                                           use_halo=True, remat=remat)
        extra = (lay_halo, plan) if use_pallas else (plan,)
        st, m = step(st, pg, *extra, sampled_idx=inp["part_idx"])
        out[f"step_{name}"] = (params_of(model), grads_of(model), float(m["loss"]),
                               float(m["train_acc"]))
    eaf.SCATTERFREE_BWD_DEFAULT = True
    out["saved"] = {remat: saved_for_backward(model_of(cfg, state, stats), shard, mesh,
                                              plan.local(i, "cpu"), idx, remat)
                    for remat in (False, True)}
    # the fused step again with the collectives timed (Mesh.spans)
    model = model_of(cfg, state, stats)
    step = make_partitioned_train_step(model, mesh, loss_mode="full", use_pallas=True,
                                       tile_nodes=TILE, use_halo=True)
    mesh.spans = {}
    step(sgd_state(model, lr), pg, lay_halo, plan, sampled_idx=inp["part_idx"])
    out["step_timed"] = (params_of(model), dict(mesh.spans))
    mesh.spans = None

    # data=2: each rank its own graph, a config that draws nothing
    mesh = make_mesh(data=2, device="cpu")
    model = model_of(inp["dp_cfg"], inp["dp_state"], None)
    st = sgd_state(model, lr)
    step = make_dp_train_step(model, mesh, loss_mode="saint")
    st, m = step(st, graph(inp["dp_plain_graphs"][mesh.index("data")]))
    out["dp"] = (params_of(model), float(m["loss"]), float(m["train_acc"]))
    out["data_sharded"] = data_sharded(torch.arange(6), mesh).tolist()

    # heads=2: the head-sharded forward and one SGD step on the same draw
    mesh = make_mesh(heads=2, device="cpu")
    model = tp_shard_model(model_of(cfg, state, stats), mesh)
    full_idx = torch.from_numpy(inp["full_idx"])
    with torch.no_grad():
        out["tp_fwd"] = amp_gcn_forward_heads(model, g, mesh, sampled_idx=full_idx).numpy()
    st = sgd_state(model, lr)
    st, m = make_tp_train_step(model, mesh, loss_mode="full")(st, g, sampled_idx=full_idx)
    out["tp_step"] = (params_of(model), float(m["loss"]))
    return out


def four_ranks(rank, inp):
    """data=2 x graph=2: one dp x graph SGD step with the halo exchange and
    the fused op, each replica its own graph."""
    cfg, state, stats, lr = inp["cfg"], inp["state"], inp["stats"], inp["lr"]
    pgs = [partition_graph(graph(a), 2) for a in inp["dp_graphs"]]
    meta = common_halo_meta(pgs)
    plans = [build_halo_plan(pg, force_meta=meta) for pg in pgs]
    layouts = stack_layouts([partition_layouts(pg, tile_nodes=TILE, edges_per_tile=128,
                                               halo_plan=pl) for pg, pl in zip(pgs, plans)])
    mesh = make_mesh(data=2, graph=2, device="cpu")
    model = model_of(cfg, state, stats)
    st = sgd_state(model, lr)
    step = make_dp_partitioned_train_step(model, mesh, loss_mode="saint", use_pallas=True,
                                          tile_nodes=TILE, use_halo=True)
    st, m = step(st, stack_partitioned(pgs), layouts, stack_halos(plans),
                 sampled_idx=inp["dp_part_idx"])
    out = {"dp_graph": (params_of(model), float(m["loss"]), float(m["train_acc"]))}

    # data=2 x heads=2: each replica its own graph and draw, heads 2 -> 1 + 1
    mesh = make_mesh(data=2, heads=2, device="cpu")
    model = tp_shard_model(model_of(cfg, state, stats), mesh)
    st = sgd_state(model, lr)
    di = mesh.index("data")
    st, m = make_dp_tp_train_step(model, mesh, loss_mode="full")(
        st, graph(inp["dp_graphs"][di]), sampled_idx=torch.from_numpy(inp["dp_full_idx"][di]))
    out["dp_tp"] = (params_of(model), float(m["loss"]))
    return out
