"""The port's profiler (``ampnet_tpu_torch/train/profiling.py``, the JAX
package's ``train/profiling.py`` on torch.profiler) on the CPU: the traced
window of steps, the trace file, the step timer, and ``profile_steps`` in
both training loops."""
import json

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig, TrainConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train import StepTimer, StepTraceCapture, trace, train_full_batch


def traced_names(path) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def run_steps(tracer, n):
    for i in range(n):
        tracer.before_step()
        with torch.profiler.record_function(f"step_{i}"):
            torch.ones(4).sum()
        tracer.after_step(block_on={"loss": torch.zeros(())})


def test_step_trace_capture_traces_steps_one_to_n(tmp_path):
    """Steps [1, 1 + n) are in the trace, step 0 (the capture) and the
    steps after the window are not; the file is a Chrome trace."""
    tracer = StepTraceCapture(str(tmp_path / "profile"), num_steps=3)
    run_steps(tracer, 6)
    tracer.close()                                   # nothing open: a no-op
    assert tracer.path == str(tmp_path / "profile" / "trace.json")
    names = traced_names(tracer.path)
    assert {"step_1", "step_2", "step_3"} <= names
    assert not names & {"step_0", "step_4", "step_5"}


def test_step_trace_capture_closes_a_short_loop(tmp_path):
    """A loop that ends inside the window still writes what it traced."""
    tracer = StepTraceCapture(str(tmp_path), num_steps=5, skip=2)
    run_steps(tracer, 4)
    assert tracer.path is None
    tracer.close()
    names = traced_names(tracer.path)
    assert {"step_2", "step_3"} <= names and "step_1" not in names


def test_trace_context_and_step_timer(tmp_path):
    with trace(str(tmp_path), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "trace.json").exists()
    with trace(str(tmp_path)):
        with torch.profiler.record_function("inside"):
            torch.ones(3).sum()
    assert "inside" in traced_names(tmp_path / "trace.json")
    timer = StepTimer()
    assert timer.summary() == {}
    for _ in range(4):
        with timer.step():
            pass
    s = timer.summary()
    assert s["steps"] == 4 and 0 <= s["p50_s"] <= s["p99_s"] and s["total_s"] >= 0


def test_train_full_batch_profiles_single_steps(tmp_path):
    """profile_steps keeps k = 1 (a k-step dispatch has no step boundaries)
    and traces the training steps after the first; the history is the one
    of the same run without the profiler."""
    rng = np.random.default_rng(0)
    n, f = 32, 12
    x = (rng.random((n, f)) < 0.3).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    g = from_arrays(x, np.stack([rng.integers(0, n, 96), rng.integers(0, n, 96)]),
                    y=rng.integers(0, 3, n), train_mask=rng.random(n) < 0.6,
                    pad_nodes_to=32, pad_edges_to=128)
    cfg = AMPGCNConfig(embedding_dim=8, num_heads=2, num_node_features=f,
                       num_sampled_vectors=3, output_dim=3, feat_emb_dim=7, val_emb_dim=1,
                       dropout_rate=0.2, use_pallas=True)
    runs = []
    for profile_steps in (0, 2):
        model = AMPGCN(cfg, scaler_stats=fit_scaler(x), device="cpu")
        tcfg = TrainConfig(learning_rate=1e-2, epochs=6, epochs_per_dispatch=3,
                           checkpoint_every=0, cosine_t0=None, seed=0,
                           profile_steps=profile_steps,
                           run_dir=str(tmp_path / f"run{profile_steps}"))
        runs.append(train_full_batch(model, g, tcfg))
    assert runs[0]["history"] == runs[1]["history"]
    names = traced_names(tmp_path / "run2" / "profile" / "trace.json")
    assert "aten::mm" in names or "aten::addmm" in names
    assert not (tmp_path / "run0" / "profile").exists()
