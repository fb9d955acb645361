"""The readings a cell's limits are set from, on the card, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds <first> --count 12 \
        [--controls 3] [--seconds 1]

For each of ``count`` seeds from ``first``: the cell's driver with a short
window (the training cells compare their first steps, which the window
does not touch; the evaluation cell compares as many of the window's
evaluations as a run does), and its readings of the program against the
reference. On the first ``controls`` seeds also: the control (the
reference a precision below the configuration's, in the program's place)
and two faults planted in the reference in the program's place: half of
the training (or evaluated) nodes left out with the mean over the rest,
and one training node's answer (its log-probs) shifted by 1; for a float32
configuration also the reference in IEEE float32 (a second witness of
what float32 rounding alone reads). A state left
unchanged reads 1 by the training measure and needs no run. One JSON line
a reading on standard output, and a summary last (largest program reading,
smallest of each other kind)."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def half_of(mask):
    import torch

    return mask & (torch.cumsum(mask.long(), 0) % 2 == 1)


class Planted:
    """A fault planted in the reference ``ref`` for the length of a ``with``."""

    def __init__(self, kind: str, ref):
        self.kind, self.ref = kind, ref

    def __enter__(self):
        import torch

        ref = self.ref
        self.saved = {k: getattr(ref, k) for k in ("nll", "saint_mean_nll", "forward")}
        nll, saint, forward = self.saved["nll"], self.saved["saint_mean_nll"], self.saved["forward"]
        if self.kind == "half_the_batch":
            ref.nll = lambda lp, y, mask: nll(lp, y, half_of(mask))
            ref.saint_mean_nll = lambda lp, y, nn, mask: saint(lp, y, nn, half_of(mask))
        elif self.kind == "answer_altered":
            def altered(P, g, *a, **kw):
                out = forward(P, g, *a, **kw)
                shift = torch.zeros_like(out)
                shift[torch.nonzero(g["train"] & g["node_mask"])[0, 0]] = 1.0
                return out + shift
            ref.forward = altered
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.ref, k, v)
        return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, required=True, help="the first seed")
    p.add_argument("--count", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    a = p.parse_args(argv)

    import torch

    from portbench.lib import cells, manifest
    from portbench.run import pin_caches

    pin_caches()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    m = manifest.load()
    rows = []
    for i in range(a.count):
        seed = a.seeds + i
        run = cells.make_run(m, a.workload, seed=seed, seconds=a.seconds, trace=False,
                             device=torch.device("cuda", 0), started=time.time())
        ref, config = run.ref, run.config
        t = time.perf_counter()
        outcome = m.driver(run.traffic["entry"])(run)
        readings = [("program", outcome.readings)]
        if i < a.controls:
            readings.append(("control", outcome.versus(ref.control_of(config))))
            for fault in ("half_the_batch", "answer_altered"):
                with Planted(fault, ref):
                    readings.append((fault, outcome.versus(ref.precision_of(config))))
            if ref.precision_of(config).conv is None:
                # a second witness: the reference itself in IEEE float32
                readings.append(("reference_f32", outcome.versus(ref.Precision(torch.float32))))
        for kind, r in readings:
            rows.append({"cell": a.workload, "seed": seed, "kind": kind, "readings": r})
            print(json.dumps(rows[-1]), flush=True)
        print(json.dumps({"seed": seed, "e2e": outcome.e2e, "seconds": time.perf_counter() - t}),
              flush=True)
        del outcome
        cells.release(run.device)
    summary = {}
    for kind in ("program", "control", "half_the_batch", "answer_altered"):
        got = [r["readings"] for r in rows if r["kind"] == kind]
        if got:
            pick = max if kind == "program" else min
            summary[kind] = {k: pick(g[k] for g in got) for k in got[0]}
    print(json.dumps({"cell": a.workload, "summary": summary,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
