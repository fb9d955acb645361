"""The manifest and the files it names: every one loads by name, a new file
of each kind is found without an edit to an existing file, and the
manifest keeps the contract's shape (names, units, metrics and cells)."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import ROOT
from portbench.lib import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return manifest.load()


def test_the_manifest_has_the_contract_keys(m):
    d = m.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert d["command"][0] == "python3" and len(d["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in d["command"])
    assert 1 <= d["run_seconds"] <= 51 and isinstance(d["run_seconds"], int)
    for p in d["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and (ROOT / p).is_dir()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_only_the_allowed_characters(m):
    d = m.data
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in d[k]]
    names += [w["config"] for w in d["workloads"]] + [w["traffic"] for w in d["workloads"]]
    names += [r for c in d["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in d[k]}) == len(d[k])
    for metric in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES
    for text in [c["why"] for c in d["configs"]] + [w["why"] for w in d["workloads"]] + \
            [c["source"] for c in d["configs"]] + [p["layer"] for p in d["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_file_loads_by_name(m):
    for c in m.data["configs"]:
        config = m.config(c["name"])
        assert (ROOT / c["file"]).resolve() == (m.bench / "configs" / f"{c['name']}.json")
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        m.reference(config["reference"]).supported(config["model"])
        assert callable(m.graph(config["graph"]["generator"]))
    for w in m.data["workloads"]:
        assert callable(m.driver(m.traffic(w["traffic"])["entry"]))
        data = m.cell_data(w["name"])
        assert data["limits"] and data["window"]["per_second"] > 0
        assert w["chips"] == 1
    for metric in m.data["per_layer"]:
        assert callable(m.reader(metric["name"]))
    for name in ("edge_attention", "gemm"):
        assert m.kernel_set(name)


def test_every_per_layer_metric_moves_a_metric_its_cells_report(m):
    e2e = {x["name"] for x in m.data["end_to_end"]}
    cells = {w["name"] for w in m.data["workloads"]}
    for metric in m.data["per_layer"]:
        assert metric["moves"] in e2e and metric["moves"] != "setup_s"
        for cell in metric.get("workloads", []):
            assert cell in cells
            assert metric["moves"] in {x["name"] for x in m.end_to_end(cell)}
    for cell in cells:
        reported = {x["name"] for x in m.end_to_end(cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert m.per_layer(cell)
    for x in m.data["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
    names = [x["name"] for x in m.data["per_layer"]]
    assert any("mfu" in n for n in names)
    assert all(x["unit"] == "%" for x in m.data["per_layer"] if x["name"].endswith("_roofline")
               or "_roofline." in x["name"])


def test_a_new_file_of_each_kind_is_found_without_editing_one(tmp_path, m):
    """A new configuration (with a reference and a graph generator of its
    own), traffic mix (with a driver of its own), metric, kernel set and
    cell, added as files and manifest entries in a copy, are found by name;
    every file the copy already had is byte for byte the same."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = tmp_path / "portbench"
    config = json.loads((bench / "configs" / "ampnet-cora-s40.json").read_text())
    config["name"] = "ampnet-cora-s24"
    config["model"]["num_sampled_vectors"] = 24
    config["reference"] = "ampgcn_mean_head"
    config["graph"]["generator"] = "ring"
    (bench / "configs" / "ampnet-cora-s24.json").write_text(json.dumps(config))
    (bench / "reference" / "ampgcn_mean_head.py").write_text("HEAD = 'mean'\n")
    (bench / "graphs" / "ring.py").write_text("def make(g):\n    return g['nodes']\n")
    traffic = json.loads((bench / "traffic" / "eval-8draw.json").read_text())
    traffic["draws"] = 4
    traffic["entry"] = "eval_twice"
    (bench / "traffic" / "eval-4draw.json").write_text(json.dumps(traffic))
    (bench / "drivers" / "eval_twice.py").write_text("def drive(run):\n    return 2\n")
    (bench / "cells" / "cora-s24.eval-4draw.json").write_text(
        json.dumps({"window": {"per_second": 60, "unit": "evals"},
                    "limits": {"eval_loss_gap": 1e-5}}))
    (bench / "kernels" / "layout.txt").write_text("\\bbuild_layout_kernel\\b\n")
    (bench / "metrics" / "layout_ms.eval.py").write_text(
        "def read(ctx):\n    return ctx.trace.device_s(ctx.kernels('layout')) * 1e3\n")
    d = json.loads((tmp_path / "BENCHMARK.json").read_text())
    d["configs"].append({"name": "ampnet-cora-s24", "source": "x", "reduced": [], "why": "x",
                         "file": "portbench/configs/ampnet-cora-s24.json"})
    d["workloads"].append({"name": "cora-s24.eval-4draw", "config": "ampnet-cora-s24",
                           "traffic": "eval-4draw", "chips": 1, "why": "x"})
    d["end_to_end"][[x["name"] for x in d["end_to_end"]].index("eval_ms")]["workloads"].append(
        "cora-s24.eval-4draw")
    d["per_layer"].append({"name": "layout_ms.eval", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "data", "moves": "eval_ms",
                           "workloads": ["cora-s24.eval-4draw"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(d))

    new = manifest.load(tmp_path)
    cell = new.cell("cora-s24.eval-4draw")
    config = new.config(cell["config"])
    assert config["model"]["num_sampled_vectors"] == 24
    assert new.reference(config["reference"]).HEAD == "mean"
    assert new.graph(config["graph"]["generator"])({"nodes": 5}) == 5
    assert new.traffic(cell["traffic"])["draws"] == 4
    assert new.driver(new.traffic(cell["traffic"])["entry"])(None) == 2
    assert new.cell_data("cora-s24.eval-4draw")["limits"] == {"eval_loss_gap": 1e-5}
    assert [x["name"] for x in new.per_layer("cora-s24.eval-4draw")] == ["layout_ms.eval"]
    assert callable(new.reader("layout_ms.eval"))
    assert new.kernel_set("layout")[0].search("void build_layout_kernel<4>(int)")
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_name_outside_the_allowed_characters_is_refused(m):
    with pytest.raises(ValueError):
        m.config("../BENCHMARK")
    with pytest.raises(FileNotFoundError):
        m.traffic("no-such-mix")
    with pytest.raises(FileNotFoundError):
        m.driver("no_such_loop")
    with pytest.raises(ValueError):
        m.reference("ampgcn.py")
    with pytest.raises(KeyError):
        m.cell("no-such-cell")
