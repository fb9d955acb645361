"""Per-path table of a chip_smoke.py log: eager and captured warm ms,
device ms and busy share (torch.profiler), CUDA-event ms, the capture's
one-off ms, and peak allocated memory of both ways of running a step (the
captured step's at its first call, capture included, and over replays,
which allocate nothing outside the graph's pool); then the captured phase
and the profile_steps line. A log of a tree whose steps were not captured
gives its eager steps' warm ms and device ms.

    python3 chip_smoke.py > chiprun_out/smoke.log 2>&1
    python3 scripts/torch_smoke_table.py chiprun_out/smoke.log

Needs no card: it reads the JSON lines the script printed."""
from __future__ import annotations

import json
import sys


def fmt(x, nd=2):
    return "n/a" if x is None else f"{x:.{nd}f}"


def main(path: str) -> int:
    rows, other = [], {}
    for line in open(path):
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "path" in obj and "profile" in obj:
            rows.append(obj)
        for key in ("captured", "profile_steps"):
            if key in obj and "path" not in obj:
                other[key] = obj[key]
    print("| path | eager warm ms | captured warm ms | capture ms | eager device ms (busy) "
          "| captured device ms (busy) | captured event ms | eager peak MB | captured peak MB "
          "(capture / replay) |")
    print("|---|---|---|---|---|---|---|---|---|")
    older = [r for r in rows if "captured" not in r]
    for r in rows:
        if "captured" not in r:
            continue
        e, c = r["eager"], r["captured"]
        ep, cp = e["profile"], c["profile"]
        print(f"| {r['path']} | {fmt(e['warm_ms'])} | {fmt(c['warm_ms'])} "
              f"| {fmt(r['capture_ms'], 0)} "
              f"| {fmt(ep.get('device_ms'))} ({fmt(ep.get('busy_share'))}) "
              f"| {fmt(cp.get('device_ms'))} ({fmt(cp.get('busy_share'))}) "
              f"| {fmt(c.get('event_ms'))} "
              f"| {e['max_memory_allocated'] / 2**20:.0f} "
              f"| {r['first_call_max_memory_allocated'] / 2**20:.0f} / "
              f"{c['max_memory_allocated'] / 2**20:.0f} |")
    if older:   # a log of a tree before the steps were captured: eager steps only
        print("| path | warm ms | device ms (busy) |")
        print("|---|---|---|")
        for r in older:
            warm = r.get("eval_step_warm_ms", r.get("train_step_warm_ms"))
            p = r["profile"]
            print(f"| {r['path']} | {fmt(warm)} | {fmt(p.get('device_ms'))} "
                  f"({fmt(p.get('busy_share'))}) |")
    for key, val in other.items():
        print(f"{key}: {json.dumps(val)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
