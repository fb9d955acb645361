"""Everything the harness reads by name: the manifest (``BENCHMARK.json``
at the checkout's root), a cell's configuration, traffic mix and data, the
driver a mix names, the reference and the graph generator a configuration
names, the per-layer metric readers and the kernel-name sets. Each lives in
a file of its own under ``portbench/``, so a new configuration, mix,
driver, reference, graph, metric or kernel family is a new file and no
existing file changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, List

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


class Manifest:
    """``BENCHMARK.json`` and the files beside it, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / "portbench"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _file(self, kind: str, name: str, suffix: str) -> Path:
        if not NAME.match(name):
            raise ValueError(f"{kind} name {name!r} is not a valid name")
        path = self.bench / kind / f"{name}{suffix}"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
        return path

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads(self._file("configs", name, ".json").read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(self._file("traffic", name, ".json").read_text())

    def cell_data(self, cell: str) -> dict:
        """``cells/<cell>.json``: the cell's window (work a second of
        ``--seconds``), its limits and the readings they were set from."""
        return json.loads(self._file("cells", cell, ".json").read_text())

    def kernel_set(self, name: str) -> List[re.Pattern]:
        """A kernel-name set: one regular expression a line, searched in a
        device operation's name; '#' starts a comment."""
        lines = self._file("kernels", name, ".txt").read_text().splitlines()
        return [re.compile(s) for s in (ln.split("#", 1)[0].strip() for ln in lines) if s]

    def _module(self, kind: str, name: str) -> ModuleType:
        """``<kind>/<name>.py`` as a module, loaded once a process."""
        path = self._file(kind, name, ".py")
        key = "portbench_" + re.sub(r"[^A-Za-z0-9_]", "_", str(path.resolve()))
        if key not in sys.modules:
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
        return sys.modules[key]

    def reader(self, metric: str) -> Callable:
        """The ``read(ctx)`` of ``metrics/<metric>.py``."""
        return self._module("metrics", metric).read

    def driver(self, entry: str) -> Callable:
        """The ``drive(run)`` of ``drivers/<entry>.py``: a traffic mix's
        ``entry``, the loop of the program its window drives."""
        return self._module("drivers", entry).drive

    def graph(self, generator: str) -> Callable:
        """The ``make(block)`` of ``graphs/<generator>.py``: a
        configuration's ``graph`` block names its generator."""
        return self._module("graphs", generator).make

    def reference(self, name: str) -> ModuleType:
        """``reference/<name>.py``, the plain reference a configuration
        names (imported as ``portbench.reference.<name>``, one module a
        process)."""
        if not MODULE.match(name):
            raise ValueError(f"reference name {name!r} is not a module name")
        self._file("reference", name, ".py")
        if self.root == ROOT:
            return importlib.import_module(f"portbench.reference.{name}")
        return self._module("reference", name)

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics a cell reports: those without a
        ``workloads`` key, and those that list it."""
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics read in a cell's traced run: those that list
        it, and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def load(root: Path = ROOT) -> Manifest:
    return Manifest(root)

