"""The port's synthetic-benchmark family against the JAX package: the
synthetic generators (array-equal for one seed), the five classifiers and
``get_model`` (forward parity with converted params and shared draws), one
``get_model('AMPNet')`` training step's loss and gradients, the tokenizer's
pca / balanced / non-downsampled modes, segment max and softmax,
``multihead_attention``, the custom MHA's option surface, BCE and the
legacy PCA preprocessor.

Tolerances: the generators, the PCA embedding, the preprocessor and the
balanced draw fed JAX's uniforms are exact (host numpy, or one index
draw); model log-probs rtol 1e-4 / atol 1e-5, as tests/test_torch_model.py
(f32, sums in another order); the training step's loss rtol 1e-5 and its
gradients rtol 2e-4 / atol 2e-6 of the largest entry, as
tests/test_torch_train.py; the ops rtol 1e-5 / atol 1e-6 (BCE, segment
ops, one attention) and the custom MHA rtol 2e-4 / atol 2e-5, as
tests/test_custom_mha.py holds it against torch. The balanced draw's
distribution: the present features' share of 8,000 draws within 0.03 of
one half (~6 standard deviations)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
from ampnet_tpu.core.config import TokenizerConfig as JaxTokenizerConfig
from ampnet_tpu.data import synthetic as jsyn
from ampnet_tpu.models import AMPGCN as JaxAMPGCN
from ampnet_tpu.models import FeatureTokenizer as JaxTokenizer
from ampnet_tpu.models import classifiers as jcls
from ampnet_tpu.ops import custom_mha as jmha
from ampnet_tpu.ops import edge_attention as jea
from ampnet_tpu.ops import segment as jseg
from ampnet_tpu.ops import tokenize as jtok
from ampnet_tpu.train import losses as jlosses
from ampnet_tpu.utils import preprocess as jpre
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig, TokenizerConfig
from ampnet_tpu_torch.data import synthetic as tsyn
from ampnet_tpu_torch.models import AMPGCN, FeatureTokenizer, ModelOutput, classifiers
from ampnet_tpu_torch.models.classifiers import get_model
from ampnet_tpu_torch.ops import custom_mha as tmha
from ampnet_tpu_torch.ops import edge_attention as tea
from ampnet_tpu_torch.ops import segment as tseg
from ampnet_tpu_torch.ops import tokenize as ttok
from ampnet_tpu_torch.ops.hopper.format import compute_layout
from ampnet_tpu_torch.train import losses as tlosses
from ampnet_tpu_torch.utils import embed_features_old

RTOL, ATOL = 1e-4, 1e-5


def assert_graphs_equal(gt, gj):
    for f in dataclasses.fields(gt):
        a, b = getattr(gt, f.name), getattr(gj, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)


def assert_same(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_same(a, b)
    elif hasattr(got, "senders"):
        assert_graphs_equal(got, want)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


# ------------------------------------------------------------------ data

GENERATORS = {
    "create_xor_data": lambda m, rng: m.create_xor_data(48, 0.2, 0.6, 0.1, rng=rng),
    "create_duplicated_xor_data":
        lambda m, rng: m.create_duplicated_xor_data(48, 0.3, 5, 3, rng=rng),
    "random_partition_graph":
        lambda m, rng: m.random_partition_graph(3, 8, 0.7, 0.2, rng=rng),
    "random_partition_graph_directed":
        lambda m, rng: m.random_partition_graph(3, 8, 0.7, 0.2, rng=rng, directed=True),
    "rpg_rgb_features": lambda m, rng: m.rpg_rgb_features(
        (rng.random((24, 24)) < 0.3).astype(np.uint8), 3, 8),
    "make_rpg_graph": lambda m, rng: m.make_rpg_graph(3, 8, rng=rng, pad_nodes_to=32),
    "get_xor_graphs": lambda m, rng: m.get_xor_graphs(48, 32, 0.3, seed=3),
    "get_duplicated_xor_graphs":
        lambda m, rng: m.get_duplicated_xor_graphs(48, 32, 0.3, 6, 2, seed=4),
    "evolve_cyclic_ca": lambda m, rng: m.evolve_cyclic_ca(
        rng.integers(0, 6, (9, 9)), 6, 20),
    "create_cyclic_ca_graph":
        lambda m, rng: m.create_cyclic_ca_graph(6, 8, 5, warmup=30, rng=rng),
    "color_histogram_embedding": lambda m, rng: m.color_histogram_embedding(
        rng.integers(0, 6, (20, 7)), 6),
    "make_cyclic_ca_graph": lambda m, rng: m.make_cyclic_ca_graph(
        6, 8, 5, embed="raw", rng=rng),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_matches_jax(name):
    """Same seed -> array-equal arrays (and dtypes) or padded Graphs."""
    fn = GENERATORS[name]
    got = fn(tsyn, np.random.default_rng(11))
    want = fn(jsyn, np.random.default_rng(11))
    assert_same(got, want)


def test_make_cyclic_ca_graph_histogram_matches_jax():
    got = tsyn.make_cyclic_ca_graph(6, 8, 4, rng=np.random.default_rng(2))
    want = jsyn.make_cyclic_ca_graph(6, 8, 4, rng=np.random.default_rng(2))
    assert_graphs_equal(got, want)
    assert got.x.shape[1] == 3 and got.test_mask is not None
    with pytest.raises(ValueError, match="weight table"):
        tsyn.color_histogram_embedding(np.zeros((2, 3)), 7)


# ------------------------------------------------------------------ classifiers

XOR = dict(num_train_samples=48, num_test_samples=48, noise_std=0.3,
           num_nearest_neighbors=5, feature_repeats=3, seed=0)
NF = 2 * XOR["feature_repeats"]


def xor_graphs():
    return jsyn.get_duplicated_xor_graphs(**XOR)[0], tsyn.get_duplicated_xor_graphs(**XOR)[0]


def with_x(gj, gt, x):
    """Both graphs with node features x [n_real, ...] (padded rows zero)."""
    pad = np.zeros((gt.x.shape[0],) + x.shape[1:], np.float32)
    pad[: x.shape[0]] = x
    return (dataclasses.replace(gj, x=jnp.asarray(pad)),
            dataclasses.replace(gt, x=torch.from_numpy(pad)))


def classifier_case(name, gj, gt):
    """(JAX model, its apply inputs, port model kwargs) per classifier."""
    x = np.asarray(gj.x)[: int(np.asarray(gj.node_mask).sum())]
    if name == "GCN":
        kw = dict(num_node_features=NF, hidden_dim=8, output_dim=2, feat_emb_dim=3,
                  val_emb_dim=1, dropout_rate=0.5, dropout_adj_rate=0.2)
        return jcls.GCN(**kw), (gj, gt), kw
    if name == "GCN_raw":
        kw = dict(num_node_features=NF, hidden_dim=8, output_dim=2, frontend="raw",
                  scaler_stats=ttok.fit_scaler(x))
        return jcls.GCN(**kw), (gj, gt), kw
    if name == "GCNOneLayer":
        kw = dict(pca_embedding=ttok.pca_feature_embedding(x, 3), num_node_features=NF,
                  num_sampled_vectors=3, output_dim=2, feat_emb_dim=3, val_emb_dim=1)
        return jcls.GCNOneLayer(**kw), (gj, gt), kw
    if name == "LinearLayer":
        return jcls.LinearLayer(out_dim=1), (gj, gt), dict(out_dim=1, in_dim=NF)
    if name == "TwoLayerSigmoid":
        return jcls.TwoLayerSigmoid(), (gj, gt), dict(in_dim=NF)
    kw = dict(num_heads=2, embed_dim=4, n_original_features=NF, out_dim=2)
    return jcls.AMPNetClassifier(**kw), with_x(gj, gt, embed_features_old(x, 3, 1)), kw


@pytest.mark.parametrize("name", ["GCN", "GCN_raw", "GCNOneLayer", "LinearLayer",
                                  "TwoLayerSigmoid", "AMPNetClassifier"])
def test_classifier_forward_matches_jax(name):
    """Converted params, deterministic forward; GCNOneLayer gets JAX's own
    balanced draw as sampled_idx. AMPNetClassifier also through the fused
    op, given a layout (the kernels' plain versions here)."""
    jm, (gj, gt), kw = classifier_case(name, *xor_graphs())
    k = jax.random.PRNGKey(1)
    rngs = {"params": k, "sample": k, "dropout": k, "edges": k}
    params = jax.jit(jm.init)(rngs, gj)["params"]
    ref = jax.jit(lambda p, g: jm.apply({"params": p}, g, deterministic=True,
                                        rngs={"sample": k}))(params, gj)
    tm = get_model(name.split("_")[0], device="cpu", **kw)
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    call = {}
    if name == "GCNOneLayer":
        call["sampled_idx"] = torch.from_numpy(np.array(ref.aux["sampled_idx"]))
    with torch.no_grad():
        out = tm(gt, return_aux=True, **call)
        plain = tm(gt, **call)
    assert isinstance(out, ModelOutput) and set(out.aux) == set(ref.aux)
    torch.testing.assert_close(plain, out.logits, rtol=0, atol=0)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits), rtol=RTOL, atol=ATOL)
    if name == "AMPNetClassifier":
        np.testing.assert_allclose(out.aux["attn_weights_2"].numpy(),
                                   np.asarray(ref.aux["attn_weights_2"]), rtol=RTOL, atol=ATOL)
        with torch.no_grad():
            got = tm(gt, edge_layout=compute_layout(gt, tile_nodes=8))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.logits), rtol=RTOL, atol=ATOL)
    # training noise draws from an explicit generator
    if name in ("GCN", "AMPNetClassifier"):
        with pytest.raises(ValueError, match="generator"):
            tm(gt, deterministic=False)
        noisy = tm(gt, deterministic=False, generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(noisy).all() and not torch.equal(noisy, plain)


def test_get_model_ampnet_train_step_matches_jax():
    """get_model('AMPNet', ...) builds the port's AMPGCN; one training
    forward (dropout rates 0, one shared draw) through the fused op on a
    layout: the masked-mean NLL and every parameter's gradient against JAX's
    (its XLA path) on the same params."""
    gj, gt = xor_graphs()
    kw = dict(embedding_dim=16, num_heads=2, num_node_features=NF, num_sampled_vectors=5,
              output_dim=2, feat_emb_dim=15, val_emb_dim=1, dropout_rate=0.0,
              dropout_adj_rate=0.0)
    jm = jcls.get_model("AMPNet", **kw)
    k = jax.random.PRNGKey(0)
    params = jax.jit(lambda r, g: jm.init(r, g, return_aux=False))(
        {"params": k, "sample": k, "dropout": k, "edges": k}, gj)["params"]
    idx = np.random.default_rng(5).integers(0, NF, (gt.x.shape[0], 5))
    train = gj.train_mask & gj.node_mask

    def loss_fn(p):
        out = jm.apply({"params": p}, gj, deterministic=True, sampled_idx=jnp.asarray(idx),
                       return_aux=False)
        return jlosses.masked_mean_nll(out.logits, gj.y, train)

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    tm = get_model("AMPNet", use_pallas=True, device="cpu", **kw)
    assert isinstance(tm, AMPGCN) and tm.config == AMPGCNConfig(use_pallas=True, **kw)
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    logits = tm(gt, deterministic=False, generator=torch.Generator().manual_seed(0),
                sampled_idx=torch.from_numpy(idx), edge_layout=compute_layout(gt, tile_nodes=8))
    loss = tlosses.masked_mean_nll(logits, gt.y, gt.train_mask & gt.node_mask)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    named = dict(tm.named_parameters())
    for name, r in flax_to_state_dict(jax.device_get(grads_j)).items():
        g, r = named[name].grad.numpy(), r.numpy()
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-6 * max(1.0, np.abs(r).max()),
                                   err_msg=name)


def test_get_model_registry():
    names = {"AMPNet": AMPGCN, "GCN": classifiers.GCN, "GCNOneLayer": classifiers.GCNOneLayer,
             "LinearLayer": classifiers.LinearLayer,
             "TwoLayerSigmoid": classifiers.TwoLayerSigmoid,
             "AMPNetClassifier": classifiers.AMPNetClassifier}
    kw = {"AMPNet": dict(embedding_dim=8, feat_emb_dim=7, num_node_features=4),
          "GCNOneLayer": dict(pca_embedding=np.zeros((4, 7), np.float32),
                              num_node_features=4),
          "AMPNetClassifier": dict(num_heads=1, embed_dim=4, n_original_features=3,
                                   out_dim=2)}
    for name, cls in names.items():
        model = get_model(name, device="cpu", **kw.get(name, {}))
        assert type(model) is cls
        hash(model.config)                        # the captured steps key on it
    with pytest.raises(KeyError, match="unknown model 'MLP'"):
        get_model("MLP")
    with pytest.raises(KeyError):
        jcls.get_model("MLP")
    with pytest.raises(TypeError, match="hidden_dim"):
        get_model("AMPNet", hidden_dim=3, device="cpu")
    assert get_model("GCN", device="cpu").config != get_model("GCN", device="cpu",
                                                              hidden_dim=8).config


# ------------------------------------------------------------------ tokenizer


def amp_pair(gj, gt, **over):
    """(JAX model, params, port model); the pca table has at most F columns."""
    kw = dict(embedding_dim=6, num_heads=2, num_node_features=NF, num_sampled_vectors=4,
              output_dim=2, feat_emb_dim=5, val_emb_dim=1, dropout_rate=0.0,
              dropout_adj_rate=0.0, **over)
    x = np.asarray(gj.x)[: int(np.asarray(gj.node_mask).sum())]
    pca = ttok.pca_feature_embedding(x, 5) if kw.get("frontend") == "pca" else None
    jm = JaxAMPGCN(config=JaxConfig(**kw), pca_embedding=pca)
    k = jax.random.PRNGKey(2)
    params = jax.jit(lambda r, g: jm.init(r, g, return_aux=False))(
        {"params": k, "sample": k, "dropout": k, "edges": k}, gj)["params"]
    tm = AMPGCN(AMPGCNConfig(**kw), pca_embedding=pca, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("over", [dict(frontend="pca"),
                                  dict(downsample_feature_vectors=False, feature_repeats=1),
                                  dict(downsample_feature_vectors=False, feature_repeats=3)],
                         ids=["pca", "all_tokens_r1", "all_tokens_r3"])
def test_tokenizer_modes_match_jax(over):
    """AMPGCN with the pca frontend (a buffer, not a parameter; one shared
    draw) and without downsampling (every feature a token, the table tiled
    feature_repeats times: S = F * repeats, sampled_idx None)."""
    gj, gt = xor_graphs()
    jm, params, tm = amp_pair(gj, gt, **over)
    call, s = {}, 4
    if "frontend" in over:
        call["sampled_idx"] = np.random.default_rng(6).integers(0, NF, (gt.x.shape[0], s))
        assert "tokenizer.pca_embedding" not in tm.state_dict()
        assert "pca_embedding" in dict(tm.tokenizer.named_buffers())
    else:
        s = NF * over["feature_repeats"]
    ref = jax.jit(lambda p, g, c: jm.apply({"params": p}, g, deterministic=True,
                                           rngs={"sample": jax.random.PRNGKey(0)}, **c))(
        params, gj, {k: jnp.asarray(v) for k, v in call.items()})
    with torch.no_grad():
        out = tm(gt, return_aux=True, **{k: torch.from_numpy(v) for k, v in call.items()})
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits), rtol=RTOL, atol=ATOL)
    assert out.aux["attn_weights_1"].shape[1:] == (s, s)
    if "frontend" not in over:
        assert out.aux["sampled_idx"] is None and ref.aux["sampled_idx"] is None


def test_tile_and_pca_match_jax(rng):
    x = (rng.random((10, 5)) < 0.4).astype(np.float32) * rng.normal(size=(10, 5)).astype(
        np.float32)
    np.testing.assert_array_equal(ttok.pca_feature_embedding(x, 3),
                                  jtok.pca_feature_embedding(x, 3))
    table = rng.normal(size=(5, 3)).astype(np.float32)
    for repeats in (1, 2):
        got = ttok.tile_all_tokens(torch.from_numpy(x), torch.from_numpy(table), repeats)
        want = jtok.tile_all_tokens(jnp.asarray(x), jnp.asarray(table), repeats)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(embed_features_old(x, 3, 2), jpre.embed_features_old(x, 3, 2))


def test_balanced_tokenizer_matches_jax_on_a_shared_draw(rng):
    """The tokenizer with balanced_sampling on an injected draw gives JAX's
    tokens; the draw itself, fed JAX's uniforms, is JAX's."""
    x = (rng.random((12, 9)) < 0.3).astype(np.float32)
    x[0] = 0.0                                       # a node with no present feature
    cfg = dict(num_node_features=9, feat_emb_dim=3, num_sampled_vectors=4,
               balanced_sampling=True)
    jt = JaxTokenizer(JaxTokenizerConfig(**cfg))
    k = jax.random.PRNGKey(3)
    params = jax.jit(jt.init)({"params": k, "sample": k}, jnp.asarray(x))
    tok_j, idx_j = jax.jit(lambda p, xx: jt.apply(p, xx, rngs={"sample": k}))(
        params, jnp.asarray(x))
    tt = FeatureTokenizer(TokenizerConfig(**cfg))
    with torch.no_grad():
        tt.feature_embedding_table.copy_(torch.from_numpy(
            np.asarray(params["params"]["feature_embedding_table"])))
        tok_t, idx_t = tt(torch.from_numpy(x), sampled_idx=torch.from_numpy(np.asarray(idx_j)))
    np.testing.assert_allclose(tok_t.numpy(), np.asarray(tok_j), rtol=1e-6, atol=1e-6)
    u = jax.random.uniform(k, x.shape, minval=np.finfo(np.float32).tiny, maxval=1.0)
    got = ttok.balanced_sample_features(torch.from_numpy(x), 4, u=torch.from_numpy(np.asarray(u)))
    want = jtok.balanced_sample_features(k, jnp.asarray(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_balanced_sample_features_distribution():
    """Without replacement (no index twice in a row), half the mass on the
    present features whatever their count, all of it on the other group
    when one group is empty."""
    n, f = 2000, 10
    x = np.zeros((n, f), np.float32)
    x[:, :2] = 1.0                                   # 2 present, 8 absent
    x[:5] = 0.0                                      # nodes with none present
    x[5:10] = 1.0                                    # nodes with none absent
    idx = ttok.balanced_sample_features(torch.from_numpy(x), 4,
                                        generator=torch.Generator().manual_seed(0))
    assert idx.shape == (n, 4) and idx.dtype == torch.int64
    assert all(len(set(row)) == 4 for row in idx.tolist())
    first = idx[10:, 0].numpy()                      # one draw from the split rows
    assert abs(float((first < 2).mean()) - 0.5) < 0.03
    share = float((idx[10:].numpy() < 2).mean())     # 4 draws w/o replacement
    assert 0.35 < share < 0.5
    assert (idx[:10] < f).all()


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("masked", [False, True])
def test_segment_max_and_softmax_match_jax(rng, masked):
    """Masked lanes, an empty segment (the fill value, and `initial`),
    integer data, and a masked logit far above the live max (no NaN in the
    live lanes' gradient)."""
    e, n = 30, 7
    data = rng.normal(size=(e, 3)).astype(np.float32)
    ids = rng.integers(0, n - 1, e)                 # segment n-1 is empty
    mask = rng.random(e) < 0.7 if masked else None
    if masked:
        data[~mask] = 90.0
    t = lambda a: None if a is None else torch.from_numpy(a)   # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)        # noqa: E731
    for initial in (None, -3.0):
        got = tseg.segment_max(t(data), t(ids), n, t(mask), initial=initial)
        want = jseg.segment_max(j(data), j(ids), n, j(mask), initial=initial)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ints = rng.integers(-50, 50, e).astype(np.int32)
    got = tseg.segment_max(t(ints), t(ids), n, t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jseg.segment_max(j(ints), j(ids), n,
                                                                            j(mask))))
    assert got.dtype == torch.int32
    logits = torch.from_numpy(data).requires_grad_()
    got = tseg.segment_softmax(logits, t(ids), n, t(mask))
    want = jseg.segment_softmax(j(data), j(ids), n, j(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    (got * torch.arange(3.0)).sum().backward()
    assert torch.isfinite(logits.grad).all()
    if masked:
        assert (got[~torch.from_numpy(mask)] == 0).all()


def test_multihead_attention_matches_jax(rng):
    b, s, d, h = 3, 5, 8, 2
    q, k, v = (rng.normal(size=(b, s, d)).astype(np.float32) for _ in range(3))
    p = [rng.normal(size=sh).astype(np.float32) * 0.3
         for sh in ((d, 3 * d), (3 * d,), (d, d), (d,))]
    for softmax in (True, False):
        out_t, w_t = tea.multihead_attention(
            *map(torch.from_numpy, (q, k, v)), tea.MHAParams(*map(torch.from_numpy, p)), h,
            softmax=softmax)
        out_j, w_j = jea.multihead_attention(*map(jnp.asarray, (q, k, v)),
                                             jea.MHAParams(*map(jnp.asarray, p)), h,
                                             softmax=softmax)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-6)


MHA_CASES = {
    "same_dim": {}, "unequal_kdim_vdim": dict(kdim=12, vdim=20),
    "add_bias_kv": dict(add_bias_kv=True), "add_zero_attn": dict(add_zero_attn=True),
    "key_padding_mask": dict(key_padding=True), "bool_attn_mask": dict(attn_mask_kind="bool"),
    "float_attn_mask": dict(attn_mask_kind="float"),
    "everything_at_once": dict(kdim=12, vdim=20, add_bias_kv=True, add_zero_attn=True,
                               key_padding=True, attn_mask_kind="float"),
    "no_softmax": dict(softmax=False),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_custom_mha_matches_jax(rng, case):
    """tests/test_custom_mha.py's cases, the port against the JAX op on the
    same params (drawn by the port's init_custom_mha)."""
    kw = dict(MHA_CASES[case])
    b, s_q, s_k, d, h = 3, 5, 6, 16, 4
    kdim, vdim = kw.pop("kdim", d), kw.pop("vdim", d)
    params = tmha.init_custom_mha(torch.Generator().manual_seed(0), d, kdim, vdim,
                                  add_bias_kv=kw.pop("add_bias_kv", False))
    q = rng.normal(size=(b, s_q, d)).astype(np.float32)
    k = rng.normal(size=(b, s_k, kdim)).astype(np.float32)
    v = rng.normal(size=(b, s_k, vdim)).astype(np.float32)
    call = dict(softmax=kw.pop("softmax", True), add_zero_attn=kw.pop("add_zero_attn", False))
    if kw.pop("key_padding", False):
        kpm = np.zeros((b, s_k), bool)
        kpm[:, -2:] = True
        call["key_padding_mask"] = kpm
    kind = kw.pop("attn_mask_kind", None)
    if kind == "bool":
        am = rng.random((s_q, s_k)) < 0.2
        am[:, 0] = False
        call["attn_mask"] = am
    elif kind == "float":
        call["attn_mask"] = ((rng.random((s_q, s_k)) < 0.2) * -1e9).astype(np.float32)
    assert not kw
    out_t, w_t = tmha.custom_multihead_attention(
        *map(torch.from_numpy, (q, k, v)), params, h,
        **{k_: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for k_, a in call.items()})
    jparams = jmha.CustomMHAParams(*(None if p is None else jnp.asarray(p.numpy())
                                     for p in params))
    out_j, w_j = jmha.custom_multihead_attention(
        *map(jnp.asarray, (q, k, v)), jparams, h,
        **{k_: jnp.asarray(a) if isinstance(a, np.ndarray) else a for k_, a in call.items()})
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=2e-4, atol=2e-5)
    if not call["softmax"]:
        assert float(w_t.min()) < 0                  # raw scores, not a distribution


def test_init_custom_mha_shapes_and_scales():
    p = tmha.init_custom_mha(torch.Generator().manual_seed(0), 64, kdim=32, vdim=48,
                             add_bias_kv=True)
    assert p.w_k.shape == (32, 64) and p.w_v.shape == (48, 64) and p.bias_k.shape == (1, 64)
    assert float(p.w_q.abs().max()) <= (6.0 / 128) ** 0.5
    assert float(p.w_out.abs().max()) <= 1.0 / 8.0
    assert all(float(b.abs().max()) == 0.0 for b in (p.b_q, p.b_k, p.b_v, p.b_out))
    assert tmha.init_custom_mha(torch.Generator(), 8).bias_k is None

    with pytest.raises(ValueError, match="divisible"):
        tmha.custom_multihead_attention(torch.zeros(1, 2, 8), torch.zeros(1, 2, 8),
                                        torch.zeros(1, 2, 8), tmha.init_custom_mha(
                                            torch.Generator(), 8), 3)


def test_bce_with_logits_matches_jax(rng):
    z = (rng.normal(size=(40, 1)) * 30).astype(np.float32)   # large |z|: the stable form
    y = rng.integers(0, 2, 40)
    m = rng.random(40) < 0.5
    for mask in (None, m, np.zeros(40, bool)):
        got = tlosses.bce_with_logits(torch.from_numpy(z), torch.from_numpy(y),
                                      None if mask is None else torch.from_numpy(mask))
        want = jlosses.bce_with_logits(jnp.asarray(z), jnp.asarray(y),
                                       None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    # the two-class log-probs of a one-logit head give the same loss as NLL
    zt = torch.from_numpy(z)
    logp = torch.cat([torch.nn.functional.logsigmoid(-zt),
                      torch.nn.functional.logsigmoid(zt)], dim=1)
    np.testing.assert_allclose(float(tlosses.masked_mean_nll(logp, torch.from_numpy(y),
                                                             torch.ones(40, dtype=torch.bool))),
                               float(tlosses.bce_with_logits(zt, torch.from_numpy(y))),
                               rtol=1e-5)


@pytest.mark.parametrize("sub", ["data", "models", "ops", "utils"])
def test_subpackage_exports_match_jax(sub):
    import importlib

    ours = importlib.import_module(f"ampnet_tpu_torch.{sub}")
    theirs = importlib.import_module(f"ampnet_tpu.{sub}")
    assert set(ours.__all__) == set(theirs.__all__)
    assert all(getattr(ours, name) is not None for name in ours.__all__)
