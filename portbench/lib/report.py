"""From a cell's outcome to its result line: the metrics of the run's kind
(end to end, or per layer from the trace), the device, the breakdown, and
the numbers compared with the reference beside their limits."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from portbench.lib import cells
from portbench.lib.manifest import Manifest
from portbench.lib.trace import Trace, breakdown
from portbench.lib.work import Shapes, Work, shapes


@dataclass
class Context:
    """What a per-layer metric's reader reads."""

    trace: Trace
    work: Work
    shapes: Shapes
    host: Dict[str, float]
    manifest: Manifest

    def kernels(self, name: str):
        return self.manifest.kernel_set(name)


def checks(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number the cell's limits name beside its limit (a limit with no
    reading is an error of the cell's file)."""
    missing = set(limits) - set(readings)
    if missing:
        raise RuntimeError(f"no reading for the limits {sorted(missing)}")
    return {k: {"value": readings[k], "limit": v} for k, v in limits.items()}


def device_info(run: cells.Run, outcome: cells.Outcome, count: int) -> dict:
    if run.device.type == "cuda":
        kind, platform = torch.cuda.get_device_name(run.device), "gpu"
    else:
        kind, platform = "cpu", "cpu"
    info = {"platform": platform, "kind": kind, "count": count,
            "memory_peak_bytes": outcome.memory_peak}
    if outcome.trace is not None:
        info["busy_s"] = outcome.trace.busy_s()
        info["window_s"] = outcome.trace.window_s
    return info


def per_layer(run: cells.Run, m: Manifest, outcome: cells.Outcome) -> Dict[str, dict]:
    ctx = Context(outcome.trace, outcome.work, shapes({"model": cells.model_fields(run.config, run.traffic)}),
                  outcome.host, m)
    out = {}
    for metric in m.per_layer(run.cell):
        value = m.reader(metric["name"])(ctx)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def execute(run: cells.Run, m: Manifest):
    """Drive the cell; (its result, its outcome) (the caller has made sure
    of the devices)."""
    outcome = m.driver(run.traffic["entry"])(run)
    cell = m.cell(run.cell)
    if run.trace:
        metrics = per_layer(run, m, outcome)
    else:
        metrics = {e["name"]: {"value": outcome.e2e[e["name"]], "unit": e["unit"]}
                   for e in m.end_to_end(run.cell)}
    compared = checks(outcome.readings, run.cell_data["limits"])
    result = {
        "correct": all(c["value"] <= c["limit"] for c in compared.values()),
        "attempted": outcome.attempted,
        "failed": 0,
        "metrics": metrics,
        "device": device_info(run, outcome, cell["chips"]),
    }
    if outcome.trace is not None:
        result["breakdown"] = breakdown(outcome.trace)
    result["checks"] = compared
    return result, outcome
