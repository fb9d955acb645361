"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: checked in fresh interpreters by
the top-level names in ``sys.modules``, compared whole (the port's own
name, ``ampnet_tpu_torch``, begins with the JAX package's)."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import ROOT

LOAD_EVERYTHING = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.lib import cells, manifest, report, trace, work, readers
from portbench.reference import saint
import ampnet_tpu_torch.train, ampnet_tpu_torch.models, ampnet_tpu_torch.data.graphsaint
import ampnet_tpu_torch.ops.hopper.format
m = manifest.load()
for w in m.data["workloads"]:
    config = m.config(w["config"]); m.cell_data(w["name"])
    m.reference(config["reference"]); m.graph(config["graph"]["generator"])
    m.driver(m.traffic(w["traffic"])["entry"])
    for metric in m.per_layer(w["name"]):
        m.reader(metric["name"])
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.reference import saint
from portbench.lib import manifest, work
m = manifest.load()
for c in m.data["configs"]:
    config = m.config(c["name"])
    m.reference(config["reference"]); m.graph(config["graph"]["generator"])
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    names = _top_level(LOAD_EVERYTHING)
    assert "ampnet_tpu_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "ampnet_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(LOAD_REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "ampnet_tpu", "ampnet_tpu_torch"}


def test_the_reference_sources_import_nothing_of_the_program():
    for path in [*(ROOT / "portbench" / "reference").glob("*.py"),
                 *(ROOT / "portbench" / "graphs").glob("*.py")]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in {"jax", "ampnet_tpu", "ampnet_tpu_torch"}, \
                    f"{path.name} imports {mod}"


def test_the_forbidden_check_compares_whole_names():
    from portbench import run

    saved = dict(sys.modules)
    try:
        sys.modules["ampnet_tpu_torch_extra"] = sys.modules["json"]
        assert "ampnet_tpu" not in run.forbidden_modules()
        sys.modules["ampnet_tpu.core"] = sys.modules["json"]
        assert run.forbidden_modules() == ["ampnet_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
