"""What a replay of a captured training step launches, as torch.profiler
sees it: path C's step (chip_smoke.py's recommended recipe at full width,
S=40) captured by ``make_train_step``, profiled ``--profiles`` times over
``--reps`` calls each, in turns with its eager body on a twin state; the
port's kernels counted by name per call, both from ``prof.events()`` (what
chip_smoke.py's ``device_profile`` reads) and from the exported Chrome
trace (what the ``profile_steps`` trace holds). Then whether the two states
still agree bit for bit (the replay ran what the eager body ran).

    python3 scripts/torch_replay_census.py [--profiles 8] [--reps 3]
                                           [--fresh-streams]
    (from the repo root, on the card)

``--fresh-streams`` captures each graph on a new stream of its own,
in place of the one side stream per device. Prints the card's name and
power limit, one JSON line per profile, then a summary line. Exits 1
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def trace_census(prof, reps: int) -> dict:
    """The port's kernels per call in the profile's exported Chrome trace."""
    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: c / reps for k, c in chip_smoke.port_kernels(names).items()}


def census(fn, reps: int) -> dict:
    """One profile of ``reps`` calls of fn (after one to warm up)."""
    import chip_smoke
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return dict(events={k: c / reps for k, c in chip_smoke.port_kernels(on_card).items()},
                trace=trace_census(prof, reps), kernels_per_call=len(on_card) / reps)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profiles", type=int, default=8)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fresh-streams", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_replay_census: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from ampnet_tpu_torch.core.config import AMPGCNConfig
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.train import create_train_state, graphs, make_optimizer
    from ampnet_tpu_torch.train import make_train_step
    from ampnet_tpu_torch.train.state import _train_step_body

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    if args.fresh_streams:
        graphs._side_stream = torch.cuda.Stream
    chip_smoke.pin_ieee_f32()
    dev = torch.device("cuda")
    data, graph = chip_smoke.cora(args.seed, dev)
    layout = compute_layout(graph)
    cfg = AMPGCNConfig(num_sampled_vectors=40, token_sampling="tfidf", scaler="precomputed",
                       dropout_rate=0.3, raw_residual="gcn2", use_pallas=True)

    def state():
        model = chip_smoke.recipe_model(cfg, data, args.seed, dev)
        return create_train_state(model, make_optimizer(
            model.parameters(), 3e-3, weight_decay=1e-3, grad_clip=1.0), seed=args.seed)

    st, st_e = state(), state()
    step, eager = make_train_step(st.model), _train_step_body(st_e.model)
    step(st, graph, layout)
    eager(st_e, graph, layout)
    rows = []
    for i in range(args.profiles):
        row = {"profile": i,
               "eager": census(lambda: eager(st_e, graph, layout), args.reps),
               "captured": census(lambda: step(st, graph, layout), args.reps)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    with torch.no_grad():
        same = all(torch.equal(a, b) for a, b in zip(st.model.parameters(),
                                                     st_e.model.parameters()))
    differ = [r["profile"] for r in rows
              if r["eager"]["events"] != r["captured"]["events"]
              or r["eager"]["trace"] != r["captured"]["trace"]]
    print(json.dumps({"fresh_streams": args.fresh_streams, "profiles": args.profiles,
                      "reps": args.reps, "profiles_where_counts_differ": differ,
                      "parameters_equal_after": same, "steps": st.step}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
