"""Tracing / profiling (``ampnet_tpu/train/profiling.py`` in torch).

The reference has no profiler (wall-clock prints only). Here:
``torch.profiler`` trace capture around training sections, written as a
Chrome / Perfetto trace (``trace.json``; open it in ui.perfetto.dev or
chrome://tracing), plus simple step-time statistics. On the card the
trace holds the host's calls and the card's kernels, those a CUDA-graph
replay launches included.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"


def _activities() -> list:
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _sync() -> None:
    """Wait for the card's queued work, where there is a card."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _export(prof, log_dir: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the block and write ``<log_dir>/trace.json``; yields the
    profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    with profile(activities=_activities()) as prof:
        yield prof
        _sync()
    _export(prof, log_dir)


class StepTraceCapture:
    """Bounded torch.profiler capture inside a training loop.

    Traces optimizer steps [skip, skip + num_steps), skipping step 0 (on
    the card its warm-up and graph capture), and writes the trace to
    ``<log_dir>/trace.json`` (``path``). Wired to TrainConfig.profile_steps.
    """

    def __init__(self, log_dir: str, num_steps: int, skip: int = 1):
        self.log_dir = log_dir
        self.start_at = skip
        self.stop_at = skip + num_steps
        self.path: Optional[str] = None
        self._seen = 0
        self._prof = None

    def before_step(self):
        if self._seen == self.start_at and self._prof is None:
            _sync()
            self._prof = profile(activities=_activities())
            self._prof.start()

    def after_step(self, block_on=None):
        """``block_on`` (the step's outputs) is the JAX signature's; the
        port waits for the whole card."""
        self._seen += 1
        if self._prof is not None:
            # sync so the traced window holds whole device steps
            _sync()
            if self._seen >= self.stop_at:
                self.close()

    def close(self):
        if self._prof is not None:   # also when the loop ends before stop_at
            self._prof.stop()
            self.path = _export(self._prof, self.log_dir)
            self._prof = None


class StepTimer:
    """Per-step wall-clock stats (mean/p50/p99) for loop instrumentation."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p99_s": ts[min(n - 1, int(n * 0.99))],
            "total_s": sum(ts),
        }
