"""Each cell at its own size on the card: the command exits 0 with a
result line that is correct. Skips where there is no CUDA device."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench.lib import manifest

CELLS = [w["name"] for w in manifest.load().data["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_is_correct_on_the_card(cuda, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                          "--seed", "4294967311", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
