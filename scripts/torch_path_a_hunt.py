"""Catches path A's intermittent error (chip_smoke.py's S=40 eval against
float64 on the CPU) by running path A in many fresh processes on the card.

    python3 scripts/torch_path_a_hunt.py [--whole N] [--short M] [--jobs J]
    (from the repo root, on the card)

Runs ``python3 chip_smoke.py`` N times one after another (every phase, then
path A and the paths after it), then ``scripts/torch_path_a_replay.py
--phases none --path-a`` M times, J at a time (a fixed-draw check, then
chip_smoke.py's own path A: the 8-draw eval step, its warm steps and
profile, then the fixed draw against float64). Each is a process of its
own. A failing path A keeps its operands and stage outputs in
chip_smoke.EVIDENCE_DIR (``scripts/torch_path_a_replay.py --analyze``
reads them). Each run's output goes to chiprun_out/path_a_hunt/; one JSON
line per run (kind, exit code, path A's logits error against float64,
seconds), then a summary line: runs, failures, the spread of the errors.
Exits 2 where a run failed, 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOGS = ROOT / "chiprun_out" / "path_a_hunt"
# path A's error against float64: chip_smoke.py's path line, the replay's
# path_a line, and the failure message of either
FAILED = r"path A S=40[^:]*: card logits disagree with the CPU float64 forward"
ERR = re.compile(r'"path": "A S=40[^"]*".*?"cpu_f64_max_abs_err": ([0-9.eE+-]+)'
                 r"|" + FAILED + r" \(max abs err ([0-9.eE+-]+)\)")


def run(kind: str, i: int, cmd) -> dict:
    t0 = time.perf_counter()
    log = LOGS / f"{kind}_{i:03d}.log"
    with open(log, "w") as f:
        rc = subprocess.run(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT).returncode
    text = log.read_text(errors="replace")
    errs = [float(a or b) for a, b in ERR.findall(text)]
    row = dict(kind=kind, run=i, rc=rc, path_a_max_abs_err=errs[0] if errs else None,
               path_a_failed=re.search(FAILED, text) is not None,
               evidence=re.findall(r'"evidence": "([^"]*)"', text),
               seconds=time.perf_counter() - t0)
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--whole", type=int, default=10)
    p.add_argument("--short", type=int, default=45)
    p.add_argument("--jobs", type=int, default=3)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    LOGS.mkdir(parents=True, exist_ok=True)
    py = sys.executable
    rows = [run("whole", i, [py, "chip_smoke.py"]) for i in range(args.whole)]
    replay = [py, "scripts/torch_path_a_replay.py", "--phases", "none", "--path-a"]
    with ThreadPoolExecutor(args.jobs) as pool:
        rows += list(pool.map(lambda i: run("short", i, replay), range(args.short)))
    errs = [r["path_a_max_abs_err"] for r in rows if r["path_a_max_abs_err"] is not None]
    failed = [r for r in rows if r["path_a_failed"] or r["rc"] != 0]
    print(json.dumps({"summary": dict(
        runs=len(rows), runs_with_path_a=len(errs),
        path_a_failures=sum(r["path_a_failed"] for r in rows),
        nonzero_exits=[(r["kind"], r["run"], r["rc"]) for r in rows if r["rc"] != 0],
        path_a_err_min=min(errs) if errs else None,
        path_a_err_median=statistics.median(errs) if errs else None,
        path_a_err_max=max(errs) if errs else None,
        distinct_errs=sorted(set(errs)))}), flush=True)
    return 2 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
