"""Seed-ensemble evaluation of the recommended hybrid recipe
(``experiments/seed_ensemble.py`` in the port).

Trains one model per seed (raw_residual=gcn2, tfidf S=40, the dataset
scaler, best-validation selection) and evaluates the ENSEMBLE: each
seed's mean log-probs over ``--eval-draws`` token draws (draw i of seed s
from a generator seeded s * 1000 + i), summed over the seeds, argmax
(``ensemble_accuracy``). The convs run the plain path on the card (the
JAX driver leaves ``use_pallas`` off).

    python -m ampnet_tpu_torch.experiments.seed_ensemble --seeds 1 2 3 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Sequence

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig, TrainConfig
from ampnet_tpu_torch.experiments.common import cora_graph, release_graphs
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train.loop import train_full_batch


def ensemble_accuracy(member_draws: Sequence[np.ndarray], y: np.ndarray,
                      mask: np.ndarray) -> float:
    """The accuracy on ``mask`` of the argmax of the sum over members of
    each member's mean log-probs over its draws (``member_draws``: one
    [draws, N, C] array per member)."""
    acc_input = None
    for draws in member_draws:
        mean_lp = np.asarray(draws, np.float32).mean(axis=0)
        acc_input = mean_lp if acc_input is None else acc_input + mean_lp
    pred = acc_input.argmax(axis=-1)
    mask = np.asarray(mask, bool)
    return float((pred[mask] == np.asarray(y)[mask]).mean())


def member_draws(model, params, graph, seed: int, draws: int) -> np.ndarray:
    """[draws, N, C] log-probs of ``params`` in ``model``, deterministic,
    draw i from a generator seeded ``seed * 1000 + i``."""
    model.load_state_dict(params)
    out = []
    with torch.no_grad():
        for i in range(draws):
            gen = torch.Generator(device=graph.x.device).manual_seed(seed * 1000 + i)
            out.append(model(graph, generator=gen).cpu().numpy())
    return np.stack(out)


def run(epochs: int = 300, seeds: Sequence[int] = (1, 2, 3), eval_draws: int = 8,
        device="cuda") -> Dict[str, Any]:
    """Train each seed, then the ensemble's val and test accuracy beside
    each member's (best-validation-selected) accuracies."""
    d, full_g = cora_graph()
    scaler_stats = fit_scaler(d.x)
    cfg = AMPGCNConfig(
        num_sampled_vectors=40, token_sampling="tfidf", scaler="precomputed",
        dropout_rate=0.3, dropout_adj_rate=0.1, raw_residual="gcn2",
    )
    members = []
    for seed in seeds:
        release_graphs()
        t0 = time.time()
        model = AMPGCN(cfg, scaler_stats=scaler_stats,
                       generator=torch.Generator().manual_seed(seed), device=device)
        tcfg = TrainConfig(
            learning_rate=3e-3, weight_decay=1e-3, epochs=epochs,
            cosine_t0=None, grad_clip=1.0, select_best_every=10,
            num_eval_samples=8, checkpoint_every=0, seed=seed,
        )
        res = train_full_batch(model, full_g, tcfg, eval_graph=full_g)
        fm = res["final_metrics"]
        members.append((seed, model, res["final_params"], fm))
        print(f"[{time.time()-t0:6.1f}s] seed {seed}: "
              f"val {fm.get('val_acc', float('nan')):.4f} "
              f"test {fm.get('test_acc', float('nan')):.4f}", flush=True)

    g = full_g.to(device)
    draws = [member_draws(model, params, g, seed, eval_draws)
             for seed, model, params, _ in members]
    y = full_g.y.numpy()
    node = full_g.node_mask.numpy()
    va = ensemble_accuracy(draws, y, full_g.val_mask.numpy() & node)
    ta = ensemble_accuracy(draws, y, full_g.test_mask.numpy() & node)
    singles = [m[3].get("test_acc", float("nan")) for m in members]
    print(f"\nensemble of {len(members)} seeds (best-val params): "
          f"val {va:.4f} test {ta:.4f}")
    print(f"single-model (best-val-selected) tests: {['%.4f' % s for s in singles]}")
    return {"seeds": list(seeds), "val_acc": va, "test_acc": ta, "single_test_accs": singles,
            "single_val_accs": [m[3].get("val_acc", float("nan")) for m in members]}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--eval-draws", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return run(a.epochs, a.seeds, a.eval_draws, a.device)


if __name__ == "__main__":
    main()
