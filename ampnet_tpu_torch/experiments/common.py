"""Shared driver helpers (``experiments/common.py`` in the port)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ampnet_tpu_torch.core.graph import Graph, from_arrays
from ampnet_tpu_torch.data.planetoid import PlanetoidData, load_cora


def cora_graph(pad_nodes_to: int = 2752,
               pad_edges_to: int = 10624) -> Tuple[PlanetoidData, Graph]:
    """Cora as a padded Graph on the CPU (2708 nodes / 10556 directed edges,
    padded as the JAX drivers pad it, ``node_norm`` ones) from
    ``load_cora()``: the Cora-shaped surrogate."""
    d = load_cora()
    g = from_arrays(
        d.x, d.edge_index, y=d.y,
        train_mask=d.train_mask, val_mask=d.val_mask, test_mask=d.test_mask,
        node_norm=np.ones(d.num_nodes, np.float32),
        pad_nodes_to=pad_nodes_to, pad_edges_to=pad_edges_to,
    )
    return d, g


def can_draw() -> bool:
    """Whether matplotlib is installed: a driver writes its numbers (CSV or
    JSON) first and draws only where it can."""
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def release_graphs() -> None:
    """Collect what an earlier run left behind before the next one in a
    driver's loop: a captured CUDA graph keeps its memory pool until the
    step that owns it, which sits in a reference cycle, is collected."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
