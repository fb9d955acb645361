"""SSL transfer measurement (``experiments/ssl_transfer.py`` in the port):
does SSL pretraining help downstream classification on the Cora-shaped
surrogate? Per seed:

  scratch       the tuned full-batch recipe from its initialization
                (tfidf S=40, precomputed scaler)
  ft-<mode>     SSL pretraining for --pretrain-epochs, then fine-tuning of
                every parameter with the same recipe (the head at its
                fresh initialization)
  probe-<mode>  SSL pretraining, then a LINEAR PROBE: every parameter but
                ``final_linear_out`` frozen (``requires_grad_(False)``:
                no gradient, no Adam state, no weight decay; the clip's
                global norm over the head's gradients only), the JAX
                driver's ``optax.multi_transform`` with ``set_to_zero``
  probe-rand    the linear probe on the fresh backbone (the control)

Every arm takes the same downstream TrainConfig (Adam lr 3e-3, wd 5e-4,
clip 1.0, 150 epochs, best-validation selection every 10, 8-draw eval).
Prints a summary table and its JSON.

    python -m ampnet_tpu_torch.experiments.ssl_transfer --seeds 0 --epochs 150
"""
from __future__ import annotations

import argparse
import copy
import json
from typing import Dict, List

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig, TrainConfig
from ampnet_tpu_torch.experiments.common import cora_graph
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train import TrainState, create_train_state, train_full_batch
from ampnet_tpu_torch.train.optim import Optimizer, make_optimizer
from ampnet_tpu_torch.train.ssl import SSLPretrainer, make_ssl_train_step

HEAD = "final_linear_out"


def build_model(d, hybrid: bool = False, seed: int = 0, device="cuda") -> AMPGCN:
    cfg = AMPGCNConfig(
        num_sampled_vectors=40, token_sampling="tfidf", scaler="precomputed",
        dropout_rate=0.3 if hybrid else 0.1,
        dropout_adj_rate=0.1 if hybrid else 0.0,
        raw_residual="gcn2" if hybrid else False)
    return AMPGCN(cfg, scaler_stats=fit_scaler(np.asarray(d.x)),
                  generator=torch.Generator().manual_seed(seed), device=device)


def pretrain_backbone(model: AMPGCN, g, mode: str, epochs: int, seed: int,
                      log_every: int = 50) -> Dict[str, torch.Tensor]:
    """SSL pretraining of a backbone of its own (``model``'s config, weights
    drawn from seed + 1000); its parameters."""
    backbone = AMPGCN(model.config, scaler_stats=(model.scaler_mean.cpu(),
                                                  model.scaler_std.cpu()),
                      generator=torch.Generator().manual_seed(1000 + seed),
                      device=next(model.parameters()).device)
    ssl = SSLPretrainer(backbone, mode=mode, num_features=int(g.x.shape[1]))
    state = create_train_state(ssl, make_optimizer(ssl.parameters(), 1e-3, grad_clip=1.0),
                               seed=seed + 1)
    step = make_ssl_train_step(ssl)
    g = g.to(next(backbone.parameters()).device)
    first = last = None
    for epoch in range(epochs):
        state, metrics = step(state, g)
        last = float(metrics["loss"])
        first = last if first is None else first
        if epoch % log_every == 0:
            print(f"  [{mode} pretrain] epoch {epoch:4d} loss {last:.4f}", flush=True)
    print(f"  [{mode} pretrain] loss {first:.4f} -> {last:.4f}", flush=True)
    return {k: v.detach().clone() for k, v in backbone.state_dict().items()}


def downstream_cfg(seed: int, epochs: int, weight_decay: float = 5e-4) -> TrainConfig:
    return TrainConfig(learning_rate=3e-3, weight_decay=weight_decay, epochs=epochs,
                       cosine_t0=None, grad_clip=1.0, seed=seed, select_best_every=10,
                       num_eval_samples=8, checkpoint_every=0, run_dir=None, log_every=50)


def transfer(fresh: Dict[str, torch.Tensor],
             backbone: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The backbone's parameters from SSL, the head's from the fresh model
    (the head gets no gradient in pretraining)."""
    return {k: (fresh[k] if k.startswith(HEAD) else backbone[k]) for k in fresh}


def probe_optimizer(model: torch.nn.Module, weight_decay: float = 5e-4) -> Optimizer:
    """Freeze every parameter but the head's and return its optimizer: the
    JAX driver's ``multi_transform(train: make_optimizer(3e-3, wd, clip
    1.0), freeze: set_to_zero)``."""
    for name, p in model.named_parameters():
        p.requires_grad_(name.startswith(HEAD))
    return make_optimizer(model.parameters(), 3e-3, weight_decay=weight_decay, grad_clip=1.0)


def run_arm(model: AMPGCN, g, cfg: TrainConfig, params: Dict[str, torch.Tensor],
            probe: bool, seed: int) -> float:
    """Train a copy of ``model`` from ``params`` (all of it, or the head
    alone with ``probe``); its final test accuracy."""
    arm = copy.deepcopy(model)
    arm.load_state_dict(params)
    opt = (probe_optimizer(arm, cfg.weight_decay) if probe else
           make_optimizer(arm.parameters(), cfg.learning_rate, weight_decay=cfg.weight_decay,
                          grad_clip=cfg.grad_clip))
    state = TrainState(arm, opt, torch.Generator(device=next(arm.parameters()).device)
                       .manual_seed(seed + 2))
    res = train_full_batch(arm, g, cfg, state=state)
    return float(res["final_metrics"]["test_acc"])


def main(seeds: List[int], pretrain_epochs: int, epochs: int, modes: List[str],
         hybrid: bool = False, probes: bool = True, device="cuda") -> Dict[str, dict]:
    d, g = cora_graph()
    results: Dict[str, List[float]] = {}
    for seed in seeds:
        model = build_model(d, hybrid=hybrid, seed=seed, device=device)
        cfg = downstream_cfg(seed, epochs, weight_decay=1e-3 if hybrid else 5e-4)
        fresh = {k: v.detach().clone() for k, v in model.state_dict().items()}

        def record(arm, acc):
            results.setdefault(arm, []).append(acc)
            print(f"== seed {seed} {arm}: test acc {acc:.4f}", flush=True)

        record("scratch", run_arm(model, g, cfg, fresh, False, seed))
        if probes:
            record("probe-rand", run_arm(model, g, cfg, fresh, True, seed))
        for mode in modes:
            pre = transfer(fresh, pretrain_backbone(model, g, mode, pretrain_epochs, seed))
            record(f"ft-{mode}", run_arm(model, g, cfg, pre, False, seed))
            if probes:
                record(f"probe-{mode}", run_arm(model, g, cfg, pre, True, seed))

    print("\n=== SSL transfer summary (test acc, mean +/- std over seeds) ===")
    summary = {}
    for arm, accs in results.items():
        summary[arm] = {"mean": float(np.mean(accs)), "std": float(np.std(accs)), "accs": accs}
        print(f"{arm:18s} {np.mean(accs):.4f} +/- {np.std(accs):.4f}  {accs}")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--pretrain-epochs", type=int, default=300)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--modes", nargs="+", default=["contrastive", "predictive"])
    p.add_argument("--hybrid", action="store_true",
                   help="downstream = the hybrid raw-residual recipe "
                        "(drop 0.3/adj 0.1/wd 1e-3, raw_residual=gcn2)")
    p.add_argument("--no-probes", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.seeds, a.pretrain_epochs, a.epochs, a.modes, hybrid=a.hybrid,
         probes=not a.no_probes, device=a.device)
