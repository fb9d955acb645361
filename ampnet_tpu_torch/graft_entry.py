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

The multi-device dry run (``dryrun_multichip``) waits for the port's
parallelism.

    python -m ampnet_tpu_torch.graft_entry
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import Graph, from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.train.state import make_predict_step


def _flagship(device="cuda") -> Tuple[AMPGCN, AMPGCNConfig, Graph]:
    """(model, config, graph on ``device``): the JAX entry's graph from the
    same draws; the model's weights from the port's seed-0 generator."""
    cfg = AMPGCNConfig()
    n, e, f = 768, 4096, 1433

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


if __name__ == "__main__":
    fn, args = entry()
    print("entry OK:", tuple(fn(*args).shape))
