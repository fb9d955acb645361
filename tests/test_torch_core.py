"""The port's configs, graphs and Cora data against the JAX package
(array-equal), and the port's independence from JAX."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from ampnet_tpu.core import config as jcfg
from ampnet_tpu.core import graph as jgraph
from ampnet_tpu.data import planetoid as jplanetoid
from ampnet_tpu_torch.core import config as cfg
from ampnet_tpu_torch.core import graph
from ampnet_tpu_torch.data import planetoid

ROOT = Path(__file__).resolve().parents[1]


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["AttentionConfig", "TokenizerConfig", "AMPGCNConfig",
                                  "TrainConfig"])
def test_configs_match_jax(name):
    ours, theirs = getattr(cfg, name), getattr(jcfg, name)
    assert _fields(ours) == _fields(theirs)
    if name == "AMPGCNConfig":
        c = dict(num_sampled_vectors=40, token_sampling="tfidf", use_pallas=True)
        assert dataclasses.asdict(ours(**c).tokenizer()) == dataclasses.asdict(theirs(**c).tokenizer())
        assert dataclasses.asdict(ours(**c).attention()) == dataclasses.asdict(theirs(**c).attention())
        with pytest.raises(ValueError, match="do not add up"):
            ours(embedding_dim=16, feat_emb_dim=7, val_emb_dim=1)


def _assert_graphs_equal(gt, gj):
    for f in dataclasses.fields(gt):
        a, b = getattr(gt, f.name), getattr(gj, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)


def test_from_arrays_and_pad_graph_match_jax(rng):
    x = rng.normal(size=(10, 5)).astype(np.float32)
    ei = np.stack([rng.integers(0, 10, 30), rng.integers(0, 10, 30)])
    kw = dict(y=rng.integers(0, 3, 10), train_mask=rng.random(10) < 0.5,
              val_mask=rng.random(10) < 0.5, test_mask=rng.random(10) < 0.5,
              node_norm=rng.random(10).astype(np.float32),
              edge_norm=rng.random(30).astype(np.float32))
    gt, gj = graph.from_arrays(x, ei, **kw), jgraph.from_arrays(x, ei, **kw)
    assert gt.num_nodes_padded == 16 and gt.num_edges_padded == 128
    _assert_graphs_equal(gt, gj)
    _assert_graphs_equal(graph.pad_graph(gt, 24, 256), jgraph.pad_graph(gj, 24, 256))
    assert gt.num_nodes == 10 and gt.num_edges == 30
    moved = gt.to("cpu")
    assert moved.y.dtype == torch.int64 and moved.edge_norm is not None
    with pytest.raises(ValueError, match="outside"):
        graph.from_arrays(x, ei + 1)
    with pytest.raises(ValueError, match="smaller"):
        graph.pad_graph(gt, 8, 256)
    with pytest.raises(ValueError, match="live edge count"):
        graph._pad_checked_edges(np.zeros(5, np.float32), 4, 8)


def test_synthetic_cora_matches_jax():
    ours, theirs = planetoid.load_cora(seed=1), jplanetoid.synthetic_cora(seed=1)
    assert ours.synthetic and ours.name == theirs.name
    for f in ("x", "y", "edge_index", "train_mask", "val_mask", "test_mask"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ours.num_classes == 7 and ours.edge_index.shape == (2, 10556)


def test_load_cora_reads_raw_files(tmp_path, rng):
    from test_data import _write_planetoid_fixture

    _write_planetoid_fixture(str(tmp_path), rng)
    ours = planetoid.load_cora(root=str(tmp_path))
    theirs = jplanetoid.load_planetoid_raw(str(tmp_path), "cora")
    assert not ours.synthetic
    for f in ("x", "y", "edge_index", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f), err_msg=f)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ampnet_tpu")
# every file of the port, by name, so that each counts as a case; the test
# below holds this list against the tree
PORT_MODULES = {
    "": ["__init__", "convert", "graft_entry", "serving"],
    "core": ["__init__", "config", "graph"],
    "data": ["__init__", "graphsaint", "native", "planetoid", "synthetic"],
    "experiments": ["__init__", "ampnet_freeze_check", "common", "contrastive_ssl_AMPNet",
                    "cora_benchmark_full", "cora_benchmark_graphsaint",
                    "cora_benchmark_graphsaint_distributed", "cora_linear_layer_baseline",
                    "cora_overfit_one_subgraph", "cosine_lr_scheduler_test", "eval_checkpoint",
                    "grid_search", "halo_budget_run", "halo_comm_accounting",
                    "partitioned_graph1_timing", "predictive_ssl_AMPNet", "raw_residual_tuning",
                    "scaling_bench", "seed_ensemble", "seed_robustness", "ssl_transfer",
                    "synthetic_rgb_generate", "synthetic_training", "synthetic_training_modular",
                    "synthetic_training_modular_graphsaint", "token_scale_tuning",
                    "transformer_tuning", "visualize_attention_coefficients",
                    "visualize_cora_attn_coeffs"],
    "interpret": ["__init__", "attention", "curves", "embedding", "histograms"],
    "models": ["__init__", "amp_gcn", "classifiers", "layers", "tokenizer"],
    "ops": ["__init__", "custom_mha", "edge_attention", "gcn", "segment", "tokenize"],
    "parallel": ["__init__", "collectives", "data_parallel", "edge_partition",
                 "head_parallel", "launch", "mesh"],
    "ops/hopper": ["__init__", "build", "edge_attention_bwd",
                   "edge_attention_bwd_scatterfree", "edge_attention_fused",
                   "edge_attention_variants", "format", "launch"],
    "train": ["__init__", "checkpoint", "graphs", "loop", "losses", "optim", "pallas_step",
              "profiling", "rundir", "ssl", "state"],
    "utils": ["__init__", "preprocess"],
}
# the port's scripts outside the package
PORT_SCRIPTS = ["chip_smoke.py", "scripts/torch_body_sweep.py", "scripts/torch_path_a_replay.py",
                "scripts/torch_gloo_cuda_probe.py"]
PORT_FILES = PORT_SCRIPTS + [
    "/".join(filter(None, ("ampnet_tpu_torch", sub, f"{mod}.py")))
    for sub, mods in PORT_MODULES.items() for mod in mods]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """The list above names every file of the port (a new module must be
    added to it), and none of them imports what is forbidden."""
    files = sorted((ROOT / "ampnet_tpu_torch").rglob("*.py")) + [ROOT / p for p in PORT_SCRIPTS]
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert names == set(PORT_FILES)
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


@pytest.mark.parametrize("name", PORT_FILES)
def test_port_file_imports_no_jax(name):
    for mod in _imports(ROOT / name):
        assert mod.split(".")[0] not in FORBIDDEN, (name, mod)
