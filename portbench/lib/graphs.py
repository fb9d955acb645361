"""The graph a cell runs on, as the benchmark hands it to the program and to
the reference. A configuration's ``graph`` block names its generator,
``portbench/graphs/<generator>.py``, whose ``make(block)`` draws it."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class GraphArrays:
    x: np.ndarray            # [N, F] float32, 0/1
    y: np.ndarray            # [N] int32
    edge_index: np.ndarray   # [2, E] int32: senders, receivers
    train_mask: np.ndarray   # [N] bool
    val_mask: np.ndarray
    test_mask: np.ndarray


def scaler(x: np.ndarray):
    """The dataset-level scaler of the recipes: column mean and population
    std over every node, float32."""
    return x.mean(axis=0).astype(np.float32), x.std(axis=0).astype(np.float32)
