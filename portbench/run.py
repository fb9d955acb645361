"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``: its configuration
(``portbench/configs/<config>.json``, which names its reference and its
graph generator), its traffic mix (``portbench/traffic/<traffic>.json``,
whose ``entry`` names the driver ``portbench/drivers/<entry>.py``) and its
data (``portbench/cells/<cell>.json``: the window's work a second, the
limits).
With ``--trace 0`` the last line of standard output is the result with the
cell's end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` and the result carries the per-layer metrics, each read
by ``portbench/metrics/<metric>.py``. The numbers compared with the
reference, each beside its limit, are the last lines of standard error and
the result's last key. No CUDA device, or fewer than the cell asks for:
exit 2, no result. A module of JAX or of the JAX package loaded by the end:
exit 3, no result."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_IMPORTED = time.time()
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names nothing in the run may load (compared whole: the
# port's own name begins with the last one)
FORBIDDEN = ("jax", "jaxlib", "flax", "ampnet_tpu")
CACHE = ROOT / ".portbench_cache"


def process_start() -> float:
    """The process's start on time.time()'s clock (from /proc where there
    is one: the interpreter's own start-up counts as set-up too)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        boot = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def pin_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; and
    no library's optional JAX or Flax back end."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    pin_caches()

    import torch

    from portbench.lib import manifest, report
    from portbench.lib.cells import make_run

    m = manifest.load()
    cell = m.cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    run = make_run(m, a.workload, seed=a.seed, seconds=a.seconds, trace=bool(a.trace),
                   device=torch.device("cuda", 0), started=started)
    result, outcome = report.execute(run, m)
    outcome.phases["result"] = time.time() - started
    print(f"portbench: phases (s from the process's start) "
          f"{json.dumps(outcome.phases)}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    print(f"portbench: readings {json.dumps(outcome.readings)}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
