"""Shared pieces of the benchmark's tests: a cell cut to a size the CPU runs
in seconds (the program then runs its plain torch versions), and the
fixture that skips a card-only test where there is no card."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small(config: dict, traffic: dict):
    """(config, traffic) at a CPU size: 200 nodes, 64 features, D=16, H=2,
    S=8 (12 for the S=64 configuration), a short sampler."""
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["graph"].update(nodes=200, features=64, classes=4, class_sizes=[40, 50, 60, 50],
                           directed_edges=800, words_per_node=6, train_per_class=5, val=40,
                           test=80, pad_nodes=256, pad_edges=896)
    wide = config["model"]["num_sampled_vectors"] > 48
    config["model"].update(embedding_dim=16, num_heads=2, num_node_features=64,
                           num_sampled_vectors=12 if wide else 8, output_dim=4, feat_emb_dim=15)
    if "sampler" in traffic:
        traffic["sampler"].update(roots=8, walk_length=20, steps=4, coverage=5)
        traffic.update(warmup_steps=2, host_timed_subgraphs=3)
    return config, traffic


@pytest.fixture
def small_run():
    """make(cell, seed=..., trace=False) -> a ``Run`` of the cell at the CPU
    size, with its committed window rate and limits."""
    import torch

    from portbench.lib import manifest
    from portbench.lib.cells import make_run

    m = manifest.load()

    def make(cell: str, seed: int = 2**31 + 11, trace: bool = False, seconds: float = 0.5):
        torch.set_num_threads(2)
        w = m.cell(cell)
        config, traffic = small(m.config(w["config"]), m.traffic(w["traffic"]))
        return make_run(m, cell, seed=seed, seconds=seconds, trace=trace,
                        device=torch.device("cpu"), started=time.time(), config=config,
                        traffic=traffic), m

    return make


@pytest.fixture
def cuda():
    """Skips the test where no CUDA device is present (decided here, at run
    time, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)
