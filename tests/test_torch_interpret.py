"""The port's interpretation suite (``ampnet_tpu_torch/interpret``) against
the JAX package's ``ampnet_tpu/interpret`` on the same numpy inputs, and
the mirror of ``tests/test_interpret.py``.

Heatmaps, top-k features, the incoming-edge view and the activation stages
are numpy on both sides: equal to the last bit (the same operations in the
same order). ``history_to_csv`` is held byte for byte. The flattened
gradients are held through ``convert.py``'s name map: a gradient tree of
the JAX model and its conversion give the same weight-like entries.
"""
import ast
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ampnet_tpu.interpret import attention as jattention
from ampnet_tpu.interpret import curves as jcurves
from ampnet_tpu.interpret import histograms as jhist
from ampnet_tpu.interpret import __all__ as jax_all
from ampnet_tpu_torch import interpret
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.interpret.attention import (
    attention_heatmaps,
    calculate_attn_heatmap,
    incoming_edge_attention,
    top_k_features_for_class,
)
from ampnet_tpu_torch.interpret.curves import history_to_csv, plot_history
from ampnet_tpu_torch.interpret.histograms import (
    _flatten_weight_grads,
    activation_stages_from_aux,
    plot_grad_flow,
    visualize_activations,
    visualize_gradients,
)
from ampnet_tpu_torch.models import AMPGCN

ROOT = Path(__file__).resolve().parents[1]
DRAWING = ("matplotlib", "seaborn", "networkx", "sklearn", "umap")


def test_exports_match_jax():
    assert sorted(interpret.__all__) == sorted(jax_all) and len(jax_all) == 18
    for name in interpret.__all__:
        assert callable(getattr(interpret, name)), name


def test_drawing_libraries_imported_only_inside_functions():
    """No module of the suite imports a drawing library at its top level:
    the numbers run where none is installed."""
    for path in sorted((ROOT / "ampnet_tpu_torch" / "interpret").glob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] in DRAWING for n in names), (path.name, names)


# ------------------------------------------------------------------ mirror of test_interpret


def test_top_k_features(rng):
    x = np.zeros((20, 10), np.float32)
    y = np.array([0] * 10 + [1] * 10)
    x[:10, 3] = 1.0  # feature 3 always present for class 0
    x[:10, 7] = (rng.random(10) < 0.5)
    top = top_k_features_for_class(x, y, 0, k=2)
    assert top[0] == 3


def test_attn_heatmap_accumulation():
    """Hand-checkable case: 1 edge, 2 tokens, known attention weights."""
    attn = np.array([[[0.25, 0.75], [0.5, 0.5]]])  # [1, 2, 2]
    sampled = np.array([[0, 1], [1, 2]])  # node0 tokens -> feats (0,1); node1 -> (1,2)
    heat, counts = calculate_attn_heatmap(
        attn, sampled, np.array([0]), np.array([1]), np.array([True]), np.array([0, 1]),
        src_class=0, dst_class=1, src_top=np.array([0, 1]), dst_top=np.array([1, 2]),
    )
    assert heat[0, 0] == 0.25
    assert heat[0, 1] == 0.75
    assert heat[1, 0] == 0.5
    assert counts.sum() == 4


def test_histograms_and_curves_smoke(tmp_path, rng):
    grads = {"conv1.w_qkv": torch.from_numpy(rng.normal(size=(8, 24)).astype(np.float32)),
             "final.weight": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
             "final.bias": None}
    out1 = visualize_gradients(grads, str(tmp_path))
    out2 = plot_grad_flow(grads, str(tmp_path))
    assert os.path.exists(out1) and os.path.exists(out2)
    out3 = visualize_activations(
        {"AmpConv 1": torch.randn(10, 4), "ReLU 1": rng.random((10, 4))}, str(tmp_path))
    assert os.path.exists(out3)
    history = [{"epoch": i, "loss": 1.0 / (i + 1), "train_acc": 0.5 + 0.01 * i}
               for i in range(5)]
    plot_history(history, str(tmp_path))
    for name in ("history.csv", "loss_curves.png", "loss_curves_log.png", "acc_curves.png"):
        assert os.path.exists(tmp_path / name), name


def test_umap_plot_fallback(tmp_path, rng):
    """plot_umap_2d always draws: umap-learn when present, the spectral
    neighbor embedding otherwise."""
    x = np.concatenate([rng.normal(size=(20, 8)), rng.normal(size=(20, 8)) + 6.0])
    out = interpret.plot_umap_2d(x.astype(np.float32), np.array([0] * 20 + [1] * 20),
                                 str(tmp_path))
    assert out is not None and os.path.exists(out)


def test_incoming_edge_attention(rng):
    senders = np.array([0, 1, 2, 3, 1])
    receivers = np.array([1, 0, 0, 2, 0])
    w = rng.normal(size=(5, 3, 3))
    y = np.array([0, 1, 1, 0])
    mask = np.array([True, True, True, True, False])
    out = incoming_edge_attention(senders, receivers, w, node=0, y=y, edge_mask=mask)
    np.testing.assert_array_equal(out["edge_ids"], [1, 2])
    np.testing.assert_array_equal(out["neighbors"], [1, 2])
    np.testing.assert_array_equal(out["neighbor_labels"], [1, 1])
    np.testing.assert_allclose(out["attention"], w[[1, 2]])


# ------------------------------------------------------------------ against the JAX suite


def attention_inputs(rng, n=60, e=400, s=6, f=40, classes=3):
    x = (rng.random((n, f)) < 0.2).astype(np.float32)
    y = rng.integers(0, classes, n)
    senders, receivers = rng.integers(0, n, e), rng.integers(0, n, e)
    mask = rng.random(e) < 0.9
    w = rng.random((e, s, s))
    idx = rng.integers(0, f, (n, s))
    return x, y, senders, receivers, mask, w, idx


def test_heatmaps_top_k_and_incoming_view_equal_jax(rng):
    x, y, senders, receivers, mask, w, idx = attention_inputs(rng)
    for c in range(3):
        np.testing.assert_array_equal(top_k_features_for_class(x, y, c, 12),
                                      jattention.top_k_features_for_class(x, y, c, 12))
    pairs = [(0, 0), (1, 2), (2, 1)]
    ours = attention_heatmaps(x, y, senders, receivers, mask, w, idx, pairs, top_k=12)
    for (cs, cd), (heat, src_top, dst_top) in ours.items():
        ref = jattention.calculate_attn_heatmap(w, idx, senders, receivers, mask, y, cs, cd,
                                                src_top, dst_top)
        got = calculate_attn_heatmap(w, idx, senders, receivers, mask, y, cs, cd,
                                     src_top, dst_top)
        np.testing.assert_array_equal(heat, ref[0])
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert ref[1].sum() > 0
    for node in (0, 7, 31):
        got = incoming_edge_attention(senders, receivers, w, node, y=y, edge_mask=mask)
        ref = jattention.incoming_edge_attention(senders, receivers, w, node, y=y,
                                                 edge_mask=mask)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


def test_history_csv_byte_for_byte(tmp_path):
    history = [{"epoch": 0, "loss": 1.25, "train_acc": 0.5},
               {"epoch": 1, "loss": 0.875, "train_acc": 0.625, "test_acc": 0.6, "lr": 3e-3},
               {"epoch": 2, "loss": 1 / 3, "val_acc": 0.1 + 0.2}]
    ours = history_to_csv(history, str(tmp_path / "port.csv"))
    ref = jcurves.history_to_csv(history, str(tmp_path / "jax.csv"))
    assert Path(ours).read_bytes() == Path(ref).read_bytes()
    assert history_to_csv([], str(tmp_path / "none.csv")) == str(tmp_path / "none.csv")
    assert not (tmp_path / "none.csv").exists()


@pytest.mark.parametrize("raw_residual", ["gcn2", False])
def test_activation_stages_from_the_port_aux_equal_jax(rng, raw_residual):
    """The stages read from a port forward's ModelOutput.aux (tensors) equal
    the JAX suite's stages read from the same numbers as numpy."""
    n, f = 20, 12
    x = (rng.random((n, f)) < 0.4).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    g = from_arrays(x, np.stack([rng.integers(0, n, 60), rng.integers(0, n, 60)]))
    model = AMPGCN(AMPGCNConfig(embedding_dim=8, num_heads=2, num_node_features=f,
                                num_sampled_vectors=3, output_dim=3, feat_emb_dim=7,
                                val_emb_dim=1, raw_residual=raw_residual), device="cpu")
    with torch.no_grad():
        out = model(g, generator=torch.Generator().manual_seed(0), return_aux=True)
    ours = activation_stages_from_aux(out.aux, out.logits)
    ref = jhist.activation_stages_from_aux(
        {k: None if v is None else v.numpy() for k, v in out.aux.items()}, out.logits.numpy())
    assert list(ours) == list(ref)
    assert ("Raw Residual" in ours) == bool(raw_residual)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
        assert np.isfinite(ours[k]).all()


def test_flattened_gradients_match_jax_through_the_name_map(rng):
    """A gradient tree shaped like the JAX recipe model's (gcn2 head, CLS,
    transformer block) and its conversion to the port's names: the same
    weight-like entries, each the same numbers (transposed kernels
    flattened in another order, so compared sorted)."""
    from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
    from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
    from ampnet_tpu.models import AMPGCN as JaxAMPGCN

    n, f = 10, 12
    cfg = dict(embedding_dim=8, num_heads=2, num_node_features=f, num_sampled_vectors=3,
               output_dim=3, feat_emb_dim=7, val_emb_dim=1, raw_residual="gcn2",
               transformer_block=True, average_pooling=False)
    x = (rng.random((n, f)) < 0.4).astype(np.float32)
    gj = jax_from_arrays(x, np.stack([rng.integers(0, n, 30), rng.integers(0, n, 30)]))
    shapes = jax.eval_shape(lambda: JaxAMPGCN(config=JaxConfig(**cfg)).init(
        {k: jax.random.PRNGKey(0) for k in ("params", "sample", "dropout", "edges")},
        gj, return_aux=False))["params"]
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    ref = jhist._flatten_weight_grads(tree)
    ours = _flatten_weight_grads(flax_to_state_dict(tree))
    model = AMPGCN(AMPGCNConfig(**cfg), device="cpu")
    assert set(flax_to_state_dict(tree)) == {k for k, _ in model.named_parameters()}

    def jax_name(name):
        return (name.replace(".lin.weight", "/Dense_0/kernel").replace(".weight", "/kernel")
                .replace(".", "/"))

    assert sorted(jax_name(k) for k in ours) == sorted(ref)
    assert {"conv1/w_qkv", "final_linear_out/kernel", "cls_token",
            "raw_residual_conv2/Dense_0/kernel"} <= set(ref)
    for k, v in ours.items():
        np.testing.assert_array_equal(np.sort(v), np.sort(ref[jax_name(k)]))
