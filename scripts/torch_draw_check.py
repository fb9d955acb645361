"""Both packages on surrogate graph draws, on the CPU: the recommended
recipe (experiments/cora_benchmark_full.py --raw-residual's protocol:
tfidf S=40, precomputed scaler, dropout 0.3, edge dropout 0.1, gcn2 head,
Adam lr 3e-3 with L2 1e-3, clip 1.0, selection every 10 epochs with the
8-draw eval, 10 epochs per dispatch) trained on the Cora-shaped surrogate
drawn from each seed (data/planetoid.py::synthetic_cora(seed), padded
2752/10624), the seed also drawing the weights and the training's random
streams, as ``scripts/torch_path_c_seeds.py --data seed`` does on the card.
``--seeds`` trains each draw once per seed given instead, the seed drawing
the weights and the training's streams (the graph stays the draw's): the
spread of each package on one draw beside the gap between them.

    python3 scripts/torch_draw_check.py [--draws 2,7] [--seeds 100,101]
                                        [--epochs 150] [--threads 8]

The JAX package trains through its XLA path (use_pallas=False), the port
through its plain path (use_pallas=False, the CPU): the same math. Each
package runs in a process of its own (the port's process imports no JAX),
one run after the other. Prints one JSON line per (package, draw, seed) with
the final test and validation accuracy and the seconds, then a summary
(each package's mean and spread per draw) beside the JAX band 0.874 +- 0.023 (README; 11 seeds on the graph of
seed 0). A draw on which JAX holds the band and the port does not is a
fault of the port; one on which both fall below it is the draw's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MEAN, JAX_STD = 0.874, 0.023
PAD_NODES, PAD_EDGES = 2752, 10624


def train_config_kwargs(seed: int, epochs: int) -> dict:
    return dict(learning_rate=3e-3, weight_decay=1e-3, epochs=epochs, seed=seed,
                cosine_t0=None, grad_clip=1.0, select_best_every=10, num_eval_samples=8,
                epochs_per_dispatch=10, log_every=10)


RECIPE = dict(num_sampled_vectors=40, token_sampling="tfidf", scaler="precomputed",
              dropout_rate=0.3, raw_residual="gcn2", use_pallas=False)


def run_jax(draw: int, seed: int, epochs: int) -> dict:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from ampnet_tpu.core.config import AMPGCNConfig, TrainConfig
    from ampnet_tpu.core.graph import from_arrays
    from ampnet_tpu.data.planetoid import synthetic_cora
    from ampnet_tpu.models import AMPGCN
    from ampnet_tpu.ops.tokenize import fit_scaler
    from ampnet_tpu.train import Logfile, train_full_batch

    d = synthetic_cora(draw)
    g = from_arrays(d.x, d.edge_index, y=d.y, train_mask=d.train_mask,
                    val_mask=d.val_mask, test_mask=d.test_mask,
                    node_norm=np.ones(d.num_nodes, np.float32),
                    pad_nodes_to=PAD_NODES, pad_edges_to=PAD_EDGES)
    model = AMPGCN(config=AMPGCNConfig(**RECIPE), scaler_stats=fit_scaler(np.asarray(d.x)))
    final = train_full_batch(model, g, TrainConfig(**train_config_kwargs(seed, epochs)),
                             log=Logfile())["final_metrics"]
    return {k: float(final[k]) for k in ("test_acc", "val_acc")}


def run_torch(draw: int, seed: int, epochs: int) -> dict:
    import torch

    from ampnet_tpu_torch.core.config import AMPGCNConfig, TrainConfig
    from ampnet_tpu_torch.core.graph import from_arrays
    from ampnet_tpu_torch.data.planetoid import synthetic_cora
    from ampnet_tpu_torch.models import AMPGCN
    from ampnet_tpu_torch.ops.tokenize import fit_scaler
    from ampnet_tpu_torch.train import Logfile, train_full_batch

    d = synthetic_cora(draw)
    g = from_arrays(d.x, d.edge_index, y=d.y, train_mask=d.train_mask,
                    val_mask=d.val_mask, test_mask=d.test_mask,
                    pad_nodes_to=PAD_NODES, pad_edges_to=PAD_EDGES)
    model = AMPGCN(AMPGCNConfig(**RECIPE), scaler_stats=fit_scaler(d.x),
                   generator=torch.Generator().manual_seed(seed), device="cpu")
    final = train_full_batch(model, g, TrainConfig(**train_config_kwargs(seed, epochs)),
                             log=Logfile())["final_metrics"]
    return {k: float(final[k]) for k in ("test_acc", "val_acc")}


def child(package: str, runs, epochs: int) -> int:
    sys.path.insert(0, ROOT)
    run = run_jax if package == "jax" else run_torch
    for draw, seed in runs:
        t0 = time.perf_counter()
        out = run(draw, seed, epochs)
        print(json.dumps(dict(package=package, draw=draw, seed=seed, epochs=epochs, **out,
                              seconds=time.perf_counter() - t0)), flush=True)
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--draws", default="2,7")
    p.add_argument("--seeds", default="",
                   help="weight seeds per draw (default: the draw's own number)")
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--threads", type=int, default=8,
                   help="the port's CPU threads (OMP_NUM_THREADS)")
    p.add_argument("--package", choices=("jax", "torch"), help=argparse.SUPPRESS)
    args = p.parse_args()
    draws = [int(s) for s in args.draws.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else []
    runs = [(d, s) for d in draws for s in (seeds or [d])]
    if args.package:
        return child(args.package, runs, args.epochs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(args.threads))
    rows = []
    for package in ("jax", "torch"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--package",
                               package, "--draws", args.draws, "--seeds", args.seeds,
                               "--epochs", str(args.epochs)],
                              env=env, cwd=ROOT, capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                rows.append(json.loads(line))
                print(line, flush=True)
    acc = {}
    for r in rows:
        acc.setdefault(f"{r['package']}_{r['draw']}", []).append(r["test_acc"])
    mean = {k: float(np.mean(v)) for k, v in acc.items()}
    inside = {k: abs(m - JAX_MEAN) <= JAX_STD for k, m in mean.items()}
    print(json.dumps({"summary": dict(
        draws=draws, seeds=seeds or "each draw's own", epochs=args.epochs, test_acc=acc,
        mean=mean, std={k: float(np.std(v)) for k, v in acc.items()},
        inside_jax_band=inside, jax_mean=JAX_MEAN, jax_std=JAX_STD,
        port_fault=[d for d in draws if inside[f"jax_{d}"] and not inside[f"torch_{d}"]])}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
