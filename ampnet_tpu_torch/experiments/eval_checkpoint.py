"""Evaluate a saved checkpoint on the full graph
(``experiments/eval_checkpoint.py`` in the port).

Point it at a run dir (``checkpoint_best.pkl``, else the newest
``checkpoint_ep*.pkl``, ``checkpoint_final.pkl`` last) or a checkpoint
file, give the model flags the run used, and it prints val/test accuracy
under the ensemble eval protocol. It reads the port's checkpoints
(``train/checkpoint.py``: ``torch.save``, read back with
``weights_only=True``), not the JAX package's.

    python -m ampnet_tpu_torch.experiments.eval_checkpoint runs/<run> \\
        --stabilized --raw-residual gcn2 --fused [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import time
from typing import Dict

import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.experiments.common import cora_graph
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.hopper.format import compute_layout
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train.checkpoint import load_checkpoint_params
from ampnet_tpu_torch.train.state import make_eval_step


def find_checkpoint(path: str) -> str:
    """``path`` itself when it is a file; else the run dir's
    checkpoint_best.pkl, else its checkpoint with the highest epoch,
    checkpoint_final.pkl after every checkpoint_ep<N>.pkl."""
    if os.path.isfile(path):
        return path
    best = os.path.join(path, "checkpoint_best.pkl")
    if os.path.exists(best):
        return best
    cands = glob.glob(os.path.join(path, "checkpoint_ep*.pkl"))
    cands += glob.glob(os.path.join(path, "checkpoint_final.pkl"))
    if not cands:
        raise FileNotFoundError(f"no checkpoints under {path}")

    def ep(p):
        m = re.search(r"ep(\d+)", os.path.basename(p))
        return int(m.group(1)) if m else 10**9  # final sorts last

    return sorted(cands, key=ep)[-1]


def model_config(stabilized: bool = False, raw_residual: str = "", fused: bool = False,
                 transformer_block: bool = False) -> AMPGCNConfig:
    """The model flags of a run, as the JAX driver builds them."""
    return AMPGCNConfig(
        embedding_dim=128, num_heads=4, num_node_features=1433,
        num_sampled_vectors=40 if stabilized else 20,
        output_dim=7, feat_emb_dim=127, val_emb_dim=1,
        token_sampling="tfidf" if stabilized else "uniform",
        scaler="precomputed" if stabilized else "batch",
        dropout_adj_rate=0.0 if fused else 0.1,
        use_pallas=fused,
        transformer_block=transformer_block,
        raw_residual=raw_residual or False,
    )


def evaluate(path: str, stabilized: bool = False, raw_residual: str = "",
             fused: bool = False, transformer_block: bool = False, ensemble: int = 8,
             seed: int = 1, device="cuda") -> Dict[str, float]:
    """The checkpoint's val and test accuracy (and losses) over ``ensemble``
    token draws from a generator seeded ``seed + 999``; with ``fused`` the
    convs run the fused kernels over the full graph's layout. ``eval_s``:
    the eval step's wall seconds (its first call: on the card the capture
    of its graph and one replay)."""
    ckpt = find_checkpoint(path)
    print(f"checkpoint: {ckpt}", flush=True)
    d, full_g = cora_graph()
    stats = fit_scaler(d.x) if stabilized else None
    cfg = model_config(stabilized, raw_residual, fused, transformer_block)
    model = AMPGCN(cfg, scaler_stats=stats,
                   generator=torch.Generator().manual_seed(seed), device=device)
    model.load_state_dict(load_checkpoint_params(ckpt))
    g = full_g.to(device)
    layout = compute_layout(g) if fused else None
    ev = make_eval_step(model, num_eval_samples=ensemble)
    t0 = time.perf_counter()
    m = ev(g, torch.Generator(device=g.x.device).manual_seed(seed + 999), layout)
    out = {k: float(v) for k, v in m.items()}
    out.update(checkpoint=ckpt, eval_s=time.perf_counter() - t0)
    print(f"val acc {out['val_acc']:.4f} | test acc {out['test_acc']:.4f}", flush=True)
    return out


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="run dir or checkpoint file")
    ap.add_argument("--stabilized", action="store_true",
                    help="model flags of the stabilized recipe "
                         "(tfidf S=40, precomputed scaler)")
    ap.add_argument("--raw-residual", type=str, default="",
                    help="'' | mlp | gcn | gcn2 (must match the run)")
    ap.add_argument("--fused", action="store_true",
                    help="use_pallas model flag (must match the run)")
    ap.add_argument("--transformer-block", action="store_true")
    ap.add_argument("--ensemble", type=int, default=8,
                    help="token-sampling draws averaged at eval")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu to evaluate on the CPU")
    a = ap.parse_args(argv)
    return evaluate(a.path, a.stabilized, a.raw_residual, a.fused, a.transformer_block,
                    a.ensemble, a.seed, a.device)


if __name__ == "__main__":
    main()
