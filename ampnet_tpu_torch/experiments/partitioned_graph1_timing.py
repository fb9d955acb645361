"""The partitioned fused path timed at graph=1
(``experiments/partitioned_graph1_timing.py`` in the port).

On a one-rank mesh the halo plan is empty (no remote senders: zero live
offsets, zero exchanges), so any ms-per-step gap between the partitioned
step (``parallel.make_partitioned_train_step``: K1 forward, K3 + K4
backward through ``fused_attention_aggregate``) and the single-device
step (``train/pallas_step.make_pallas_train_step`` on a layout without a
sender side: K1 forward, K5 backward) is the partitioned path's own
plumbing and the aggregate op's body. The partitioned step also runs
with the plain convs ('xla', the JAX label).

The rank runs in a one-process group (NCCL on the card, gloo on the CPU),
its steps eager from the host ('partitioned_*_ms'). The device loop
('*_deviceloop_ms') is ten partitioned steps captured in one CUDA graph
and replayed; at graph=1 no collective is needed, so it runs on the
rank's mesh with the one-rank groups dropped (a gloo collective cannot be
captured). On the CPU the device loop is the same ten steps eager. The
single-device step is a captured graph on the card, as every training
step there. Both paths start from the same weights and the same
generator seed, so their first losses agree (``loss_single``,
``loss_partitioned``).

    python -m ampnet_tpu_torch.experiments.partitioned_graph1_timing [--iters 10] \\
        [--device cpu]
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
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
    partition_layouts,
)
from ampnet_tpu_torch.train.optim import make_optimizer
from ampnet_tpu_torch.train.pallas_step import (
    compute_layout,
    default_edge_budget,
    make_pallas_train_step,
)
from ampnet_tpu_torch.train.state import TrainState

TILE_NODES = 256
LOOP_STEPS = 10
NODES, EDGES = 2712, 10556   # full-batch Cora's shape, as the JAX driver's


def problem(n_g: int = NODES, e: int = EDGES):
    """Full-batch Cora's shape: random sparse features, random edges."""
    rng = np.random.default_rng(0)
    xf = (rng.random((n_g, 1433)) < 0.02).astype(np.float32)
    xf[xf.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n_g, e), rng.integers(0, n_g, e)])
    return from_arrays(xf, ei, y=rng.integers(0, 7, n_g), train_mask=np.ones(n_g, bool),
                       node_norm=np.ones(n_g, np.float32))


def timing_config() -> AMPGCNConfig:
    """The JAX driver's model: the defaults (D=128, H=4, S=20), no dropout."""
    return AMPGCNConfig(dropout_rate=0.0, dropout_adj_rate=0.0)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, iters: int, device) -> float:
    """ms per call of ``fn`` over ``iters`` calls, the device synchronized
    at both ends."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def device_loop(step, state: TrainState, args: tuple, device) -> float:
    """ms per step of ``LOOP_STEPS`` steps in one dispatch: one CUDA graph
    replay on the card (captured after a warm-up on a side stream), the
    steps eager on the CPU."""
    def body():
        for _ in range(LOOP_STEPS):
            step(state, *args)

    if device.type != "cuda":
        return _timed(body, 1, device) / LOOP_STEPS
    from ampnet_tpu_torch.train import graphs

    opt = state.optimizer
    count = opt.count
    captured = graphs.Captured(lambda: body(), (), writes=[*state.model.parameters(),
                                                           *opt.tensors()],
                               generator=state.generator,
                               what=f"{LOOP_STEPS} partitioned steps")
    opt.count = count
    captured.replay(())
    return _timed(lambda: captured.replay(()), 1, device) / LOOP_STEPS


def timing_rank(rank: int, iters: int, nodes: int, edges: int,
                device="cuda") -> Dict[str, Any]:
    """The one rank: the single-device step, then the partitioned step
    fused and plain, each eager and as a device loop; the kernels each
    launched (``launches``: none on the CPU, where the plain versions run)."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    def launched():
        out = {k: n for k, n in eaf.launch_counts().items() if n}
        eaf.reset_launch_counts()
        return out

    mesh = make_mesh(data=1, graph=1, device=device)
    dev = mesh.device
    g = problem(nodes, edges)
    cfg = timing_config()
    model = AMPGCN(cfg, device=dev)
    start = copy.deepcopy(model.state_dict())

    def fresh_state(seed=0):
        m = AMPGCN(cfg, device=dev)
        m.load_state_dict(start)
        return TrainState(m, make_optimizer(m.parameters(), 1e-3),
                          torch.Generator(device=dev).manual_seed(seed))

    # the single-device path (bench.py's train-step protocol)
    budget = default_edge_budget(g.num_edges_padded, -(-g.num_nodes_padded // 256), slack=4.0)
    gd = g.to(dev)
    layout1 = compute_layout(gd, edges_per_tile=budget, sender_layout=False)
    state = fresh_state()
    step1 = make_pallas_train_step(state.model, loss_mode="saint")
    launched()
    _, m = step1(state, gd, layout1)
    out = {"loss_single": float(m["loss"])}
    out["single_ms"] = _timed(lambda: step1(state, gd, layout1), iters, dev)
    counts = {"single": launched()}
    print(f"single-device fused step: {out['single_ms']:.2f} ms", file=sys.stderr)

    pg = partition_graph(g, 1)
    plan = build_halo_plan(pg)
    if plan.offsets != ():
        raise AssertionError("graph=1 must have zero live offsets")
    i = (0,)
    shard = pg.local(i, dev)
    halo = plan.local(i, dev)
    lay = partition_layouts(pg, tile_nodes=TILE_NODES, halo_plan=plan).local(i, dev)
    for label, use_pallas in (("fused", True), ("xla", False)):
        extra = (lay, halo) if use_pallas else (halo,)
        st = fresh_state()
        stepP = make_partitioned_train_step(st.model, mesh, loss_mode="saint",
                                            use_pallas=use_pallas, tile_nodes=TILE_NODES,
                                            use_halo=True)
        _, m = stepP(st, shard, *extra)
        if use_pallas:
            out["loss_partitioned"] = float(m["loss"])
        ms = _timed(lambda: stepP(st, shard, *extra), iters, dev)
        out[f"partitioned_{label}_ms"] = ms
        counts[f"partitioned_{label}"] = launched()
        print(f"partitioned (graph=1) {label} step: {ms:.2f} ms", file=sys.stderr)
        # the device loop: the same step on the rank's mesh without its
        # one-rank groups (nothing to exchange at graph=1)
        alone = dataclasses.replace(mesh, groups={a: None for a in mesh.groups})
        stepL = make_partitioned_train_step(st.model, alone, loss_mode="saint",
                                            use_pallas=use_pallas, tile_nodes=TILE_NODES,
                                            use_halo=True)
        dev_ms = device_loop(stepL, st, (shard, *extra), dev)
        out[f"partitioned_{label}_deviceloop_ms"] = dev_ms
        counts[f"partitioned_{label}_deviceloop"] = launched()
        out[f"loss_finite_{label}"] = bool(np.isfinite(float(m["loss"])))
        print(f"partitioned (graph=1) {label} DEVICE-LOOP step: {dev_ms:.2f} ms",
              file=sys.stderr)
    out.update(backend=mesh.backend, device=str(dev), staged=dict(mesh.staged),
               moved=dict(mesh.moved), launches=counts, steps=1 + iters,
               loop_steps=2 * LOOP_STEPS if dev.type == "cuda" else LOOP_STEPS)
    return out


def run(iters: int = 10, device="cuda") -> Dict[str, Any]:
    """The JSON line's numbers (unrounded). The rank is spawned and imports
    this module afresh, so it is given the graph's shape (``NODES``,
    ``EDGES``) as read here."""
    from ampnet_tpu_torch.parallel.launch import spawn

    on_card = torch.device(device).type == "cuda"
    nodes, edges = NODES, EDGES
    (r,) = spawn(timing_rank, 1, iters, nodes, edges, device,
                 backend="nccl" if on_card else "gloo", device=device)
    single = r["single_ms"]
    return {
        "partitioned_fused_ms": r["partitioned_fused_ms"],
        "partitioned_fused_deviceloop_ms": r["partitioned_fused_deviceloop_ms"],
        "partitioned_xla_ms": r["partitioned_xla_ms"],
        "partitioned_xla_deviceloop_ms": r["partitioned_xla_deviceloop_ms"],
        "single_ms": single,
        "ratio": r["partitioned_fused_ms"] / single,
        "ratio_deviceloop": r["partitioned_fused_deviceloop_ms"] / single,
        "loss_single": r["loss_single"], "loss_partitioned": r["loss_partitioned"],
        "shape": f"full-batch Cora's (N={nodes}, E={edges}, S=20, D=128, H=4)",
        "backward": "partitioned: scatter-free (K3 + K4); single: stream (K5)",
        "loss_finite": r["loss_finite_fused"] and r["loss_finite_xla"],
        "backend": r["backend"], "device": r["device"], "moved": r["moved"],
        "launches": r["launches"], "steps": r["steps"], "loop_steps": r["loop_steps"],
        "note": "graph=1: empty halo plan (zero exchanges); the delta is the partitioned "
                "path's plumbing + fused_attention_aggregate's body",
    }


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = run(a.iters, a.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
