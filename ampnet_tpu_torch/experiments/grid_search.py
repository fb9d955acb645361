"""Hyperparameter grid search (``experiments/grid_search.py`` in the port):
noise_std in {0.1 .. 0.6} x repeats of the modular XOR trainer, a run
dir per experiment, the results in grid_search.csv and a boxplot of the
max test accuracy per noise level (drawn where matplotlib is installed).

``--workers N`` runs the experiments in a spawn-context pool of N
processes, as the reference's ``mp.Pool``. The children train where the
parent would, on the card unless ``--cpu`` sends them to the CPU (several
children share the one card); each reports the device it trained on. The
default stays sequential.

    python -m ampnet_tpu_torch.experiments.grid_search [--repeats 5] \\
        [--workers 2] [--cpu]
"""
from __future__ import annotations

import argparse
import csv
import multiprocessing as mp
import os
from typing import Any, Dict, List, Sequence, Tuple

from ampnet_tpu_torch.experiments.common import can_draw
from ampnet_tpu_torch.experiments.synthetic_training_modular import train
from ampnet_tpu_torch.interpret.curves import plot_history, pyplot
from ampnet_tpu_torch.train import create_run_dir

EPOCHS = 100   # each experiment's, as the JAX driver's


def run_experiment(noise_std: float, repeat: int, run_base: str,
                   device="cuda") -> Tuple[float, float, float, Dict[str, Any]]:
    """One experiment (its curves drawn where matplotlib is installed):
    (noise_std, max train acc, max test acc, where) with ``where`` the
    device it trained on and the kernels it launched."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    eaf.reset_launch_counts()
    result = train({"noise_std": noise_std, "seed": repeat, "epochs": EPOCHS},
                   run_base=os.path.join(run_base, f"noise{noise_std}_rep{repeat}"),
                   device=device)
    if can_draw():
        plot_history(result["history"], result["run_dir"])
    where = {"device": str(_device_of(device)), "pid": os.getpid(),
             "launches": {k: n for k, n in eaf.launch_counts().items() if n}}
    return noise_std, result["max_train_acc"], result["max_test_acc"], where


def _device_of(device):
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def controller(noise_stds: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6),
               repeats: int = 5, run_base: str = None, workers: int = 0,
               device="cuda") -> Dict[str, Any]:
    """Every (noise_std, repeat) experiment, sequential or in a pool of
    ``workers``; the CSV written (and the boxplot where it can be drawn).
    Returns the (noise_std, max train acc, max test acc) rows sorted by
    noise, each experiment's device and launches, and the run dir."""
    run_base = run_base or create_run_dir("runs", details="grid search")
    jobs = [(ns, rep) for ns in noise_stds for rep in range(repeats)]
    if workers > 1:
        ctx = mp.get_context("spawn")
        with ctx.Pool(workers) as pool:
            handles = [pool.apply_async(run_experiment, (ns, rep, run_base, device))
                       for ns, rep in jobs]
            out = [h.get() for h in handles]
    else:
        out = [run_experiment(ns, rep, run_base, device) for ns, rep in jobs]
    out.sort(key=lambda r: r[0])
    results = [r[:3] for r in out]
    write_csv(results, run_base)
    if can_draw():
        plot_search_figure(results, run_base)
    return {"results": results, "where": [r[3] for r in out], "run_base": run_base}


def write_csv(results: List[Tuple[float, float, float]], run_base: str) -> str:
    path = os.path.join(run_base, "grid_search.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["noise_std", "max_train_acc", "max_test_acc"])
        w.writerows(results)
    return path


def plot_search_figure(results, run_base) -> str:
    plt = pyplot()
    by_noise = {}
    for ns, tr, te in results:
        by_noise.setdefault(ns, []).append(te)
    fig, ax = plt.subplots(figsize=(8, 5))
    keys = sorted(by_noise)
    ax.boxplot([by_noise[k] for k in keys])
    ax.set_xticks(range(1, len(keys) + 1), [str(k) for k in keys])
    ax.set_xlabel("noise_std")
    ax.set_ylabel("max test accuracy")
    ax.set_title("XOR grid search")
    out = os.path.join(run_base, "grid_search_boxplot.png")
    fig.savefig(out, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--workers", type=int, default=0,
                   help="process-pool size (reference used mp.Pool(3)); 0/1 = sequential")
    p.add_argument("--cpu", action="store_true", help="train on the CPU")
    a = p.parse_args()
    controller(repeats=a.repeats, workers=a.workers, device="cpu" if a.cpu else "cuda")
