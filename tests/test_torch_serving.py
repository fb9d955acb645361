"""The port's serving surface against the JAX package's: ``Predictor``
(buckets, one forward per bucket, real-node log-probs, hot swap), the
params-only checkpoint, the top-level exports, the graph helpers and
``SaintConfig``.

The two Predictors get the same converted params and the same token draw:
each package's present-feature sampler is replaced, in this test only, by
one deterministic rule (a node's present features in ascending order,
repeated), since the two frameworks' random streams differ. The model is
invariant to the order of a node's tokens (no positional term; mean
pooling), which ``test_answers_do_not_depend_on_token_order`` holds.

Tolerance: rtol 1e-4 / atol 1e-5 on log-probs (f32, sums in another
order), as the model parity tests."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ampnet_tpu
import ampnet_tpu_torch
from ampnet_tpu.core import config as jax_config
from ampnet_tpu.core import graph as jax_graph
from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
from ampnet_tpu.models import AMPGCN as JaxAMPGCN
from ampnet_tpu.models import tokenizer as jax_tokenizer
from ampnet_tpu.serving import Predictor as JaxPredictor
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core import config as torch_config
from ampnet_tpu_torch.core import graph as torch_graph
from ampnet_tpu_torch.core.config import AMPGCNConfig, TrainConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.models import tokenizer as torch_tokenizer
from ampnet_tpu_torch.ops.hopper.format import default_edge_budget, required_edge_budget
from ampnet_tpu_torch.serving import Predictor
from ampnet_tpu_torch.train import (
    create_train_state,
    load_checkpoint_params,
    load_params,
    make_optimizer,
    make_train_step,
    save_checkpoint,
    save_params,
)

RTOL, ATOL = 1e-4, 1e-5
F, NB, EB = 24, 32, 64
CFG = dict(embedding_dim=8, num_heads=2, num_node_features=F, num_sampled_vectors=6,
           output_dim=3, feat_emb_dim=7, val_emb_dim=1, dropout_rate=0.0,
           dropout_adj_rate=0.0)


def make_inputs(rng, n=10, e=30):
    x = (rng.random((n, F)) < 0.3).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    return x, np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])


def jax_first_present(key, x, num_samples):
    present = x != 0
    order = jnp.argsort(jnp.where(present, 0, 1), axis=1, stable=True)
    count = jnp.maximum(present.sum(axis=1, keepdims=True), 1)
    return jnp.take_along_axis(order, jnp.arange(num_samples)[None] % count, axis=1)


def torch_first_present(x, num_samples, generator=None):
    present = x != 0
    order = torch.sort((~present).to(torch.int8), dim=1, stable=True).indices
    count = present.sum(dim=1, keepdim=True).clamp_min(1)
    return torch.gather(order, 1, torch.arange(num_samples)[None] % count)


@pytest.fixture
def same_draws(monkeypatch):
    monkeypatch.setattr(jax_tokenizer, "sample_present_features", jax_first_present)
    monkeypatch.setattr(torch_tokenizer, "sample_present_features", torch_first_present)


def both(rng, **over):
    """A JAX model and its params, and the port's model holding nothing of
    them yet (seed 5): the Predictor loads the converted params."""
    x, ei = make_inputs(rng)
    cfg = {**CFG, **over}
    jm = JaxAMPGCN(config=JaxConfig(**cfg))
    k = jax.random.PRNGKey(0)
    params = jm.init({"params": k, "sample": k, "dropout": k, "edges": k},
                     jax_graph.from_arrays(x, ei))["params"]
    tm = AMPGCN(AMPGCNConfig(**cfg), generator=torch.Generator().manual_seed(5),
                device="cpu")
    return jm, params, tm, flax_to_state_dict(jax.device_get(params))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_predictor_matches_jax_predictor(rng, same_draws, use_pallas):
    """Same bucket shapes (JAX keeps one jitted forward per bucket; the
    port's one capture per bucket is held on the card), real-node log-probs
    whose exp rows sum to 1, and the same answers (the port with use_pallas
    through its fused op's plain versions on the bucket's layout, at the
    bucket's default edge budget; the JAX Predictor through XLA)."""
    jm, params, tm, sd = both(rng, use_pallas=use_pallas)
    jp = JaxPredictor(jm, params, bucket_nodes=NB, bucket_edges=EB)
    tp = Predictor(tm, sd, bucket_nodes=NB, bucket_edges=EB)
    requests = [make_inputs(rng, n, e) for n, e in ((10, 30), (12, 40), (40, 70), (33, 100))]
    for x, ei in requests:
        assert tp._bucket(x.shape[0], ei.shape[1]) == jp._bucket(x.shape[0], ei.shape[1])
        want = jp.predict(x, ei)
        got = tp.predict(x, ei)
        assert got.shape == (x.shape[0], CFG["output_dim"]) == want.shape
        np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-5)
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    buckets = {tp._bucket(x.shape[0], ei.shape[1]) for x, ei in requests}
    assert buckets == set(jp._fns) == {(32, 64), (64, 128)}
    if use_pallas:
        g = from_arrays(*requests[2], pad_nodes_to=64, pad_edges_to=128)
        lay = tp.layout(g)
        assert lay.snd_ptr is None
        assert lay.tile_senders.shape == (1, default_edge_budget(128, 1))
    else:
        assert tp.layout(from_arrays(*requests[0])) is None


def test_layout_budget_grows_past_a_skewed_tile(rng):
    """A bucket's layouts start at ``default_edge_budget`` of its padded
    sizes (4 tiles of 256 nodes, 1,024 edges: 640 a tile); a request whose
    edges crowd one tile past it grows the bucket's budget to that
    request's ``required_edge_budget``, and later requests of the bucket
    keep the grown budget (the same layout shapes: one capture)."""
    _, _, tm, _ = both(rng, use_pallas=True)
    pred = Predictor(tm, bucket_nodes=1024, bucket_edges=1024)
    n = 1000
    x = (rng.random((n, F)) < 0.3).astype(np.float32)
    spread = np.stack([rng.integers(0, n, 900), rng.integers(0, n, 900)])
    crowded = np.stack([rng.integers(0, n, 900), rng.integers(0, 200, 900)])

    def tile_edges(ei):
        return pred.layout(from_arrays(x, ei, pad_nodes_to=1024,
                                       pad_edges_to=1024)).tile_senders.shape[1]

    assert default_edge_budget(1024, 4) == 640 == tile_edges(spread)
    grown = required_edge_budget(from_arrays(x, crowded, pad_nodes_to=1024,
                                             pad_edges_to=1024))
    assert grown > 640 and tile_edges(crowded) == grown
    assert tile_edges(spread) == grown


def test_answers_do_not_depend_on_token_order(rng):
    """What lets the Predictor test share a draw: permuting each node's
    sampled tokens leaves the log-probs unchanged up to f32 rounding."""
    _, _, tm, _ = both(rng)
    x, ei = make_inputs(rng)
    g = from_arrays(x, ei, pad_nodes_to=16, pad_edges_to=32)
    idx = torch.from_numpy(rng.integers(0, F, (16, CFG["num_sampled_vectors"])))
    perm = torch.from_numpy(rng.permuted(np.tile(np.arange(idx.shape[1]), (16, 1)), axis=1))
    with torch.no_grad():
        a = tm(g, sampled_idx=idx)
        b = tm(g, sampled_idx=torch.gather(idx, 1, perm))
    assert not torch.equal(idx, torch.gather(idx, 1, perm))
    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_predictor_draws_from_its_own_generator(rng):
    """Without a generator the draws come from the Predictor's own, seeded
    with ``seed`` (successive answers differ, two Predictors of one seed
    agree); a given generator repeats."""
    _, _, tm, _ = both(rng)
    x, ei = make_inputs(rng)
    a, b = Predictor(tm, seed=3), Predictor(tm, seed=3)
    first = a.predict(x, ei)
    np.testing.assert_array_equal(first, b.predict(x, ei))
    assert not np.array_equal(first, a.predict(x, ei))
    fixed = [a.predict(x, ei, generator=torch.Generator().manual_seed(9)) for _ in range(2)]
    np.testing.assert_array_equal(*fixed)


def checkpoint(tm, rng, path):
    """One training step of the port on a small graph, then a checkpoint."""
    x, ei = make_inputs(rng)
    g = from_arrays(x, ei, y=rng.integers(0, 3, 10), train_mask=np.ones(10, bool),
                    pad_nodes_to=NB, pad_edges_to=EB)
    state = create_train_state(tm, make_optimizer(tm.parameters(), 1e-2), seed=7)
    make_train_step(tm)(state, g)
    return save_checkpoint(path, state, epoch=0)


def test_hot_swap_loads_a_checkpoint_in_place(rng, tmp_path):
    """``load_params`` copies a checkpoint's params into the model's own
    tensors (the same storage: a captured graph replays on them): the
    answers change, and equal a fresh Predictor's over a model loaded from
    the same checkpoint."""
    _, _, tm, _ = both(rng)
    trained = AMPGCN(tm.config, generator=torch.Generator().manual_seed(5), device="cpu")
    path = checkpoint(trained, rng, str(tmp_path / "ck.pkl"))
    pred = Predictor(tm)
    x, ei = make_inputs(rng)
    before = pred.predict(x, ei, generator=torch.Generator().manual_seed(1))
    ptrs = {k: p.data_ptr() for k, p in tm.named_parameters()}
    pred.load_params(path)
    assert ptrs == {k: p.data_ptr() for k, p in tm.named_parameters()}
    after = pred.predict(x, ei, generator=torch.Generator().manual_seed(1))
    assert not np.allclose(before, after)
    fresh = AMPGCN(tm.config, generator=torch.Generator().manual_seed(11), device="cpu")
    ref = Predictor(fresh, params=load_checkpoint_params(path))
    np.testing.assert_array_equal(after, ref.predict(
        x, ei, generator=torch.Generator().manual_seed(1)))


@pytest.mark.parametrize("as_module", [True, False])
def test_save_and_load_params_round_trip_in_place(rng, tmp_path, as_module):
    _, _, tm, _ = both(rng, transformer_block=True, average_pooling=False)
    path = save_params(str(tmp_path / "sub" / "params.pt"),
                       tm if as_module else tm.state_dict())
    other = AMPGCN(tm.config, generator=torch.Generator().manual_seed(6), device="cpu")
    ptrs = {k: p.data_ptr() for k, p in other.named_parameters()}
    assert not torch.equal(other.cls_token, tm.cls_token)
    assert load_params(path, other) is other
    assert ptrs == {k: p.data_ptr() for k, p in other.named_parameters()}
    for (k, p), q in zip(tm.named_parameters(), other.parameters()):
        assert torch.equal(p, q), k
    wrong = AMPGCN(dataclasses.replace(tm.config, average_pooling=True), device="cpu")
    with pytest.raises(RuntimeError, match="cls_token"):
        load_params(path, wrong)


def test_exports_match_the_jax_package():
    """The port exports what the JAX package does, but the classifiers
    (models/classifiers.py, not ported yet)."""
    classifiers = {"AMPNetClassifier", "GCN", "GCNOneLayer", "LinearLayer", "TwoLayerSigmoid"}
    assert set(ampnet_tpu_torch.__all__) == set(ampnet_tpu.__all__) - classifiers
    for name in ampnet_tpu_torch.__all__:
        assert getattr(ampnet_tpu_torch, name) is not None


def test_sort_edges_by_receiver_matches_jax(rng):
    x, ei = make_inputs(rng, n=12, e=40)
    gj = jax_graph.from_arrays(x, ei, pad_edges_to=64,
                               edge_norm=rng.random(40).astype(np.float32))
    gt = from_arrays(x, ei, pad_edges_to=64, edge_norm=np.asarray(gj.edge_norm)[:40])
    sj, pj = jax_graph.sort_edges_by_receiver(gj)
    st, pt = torch_graph.sort_edges_by_receiver(gt)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    for f in ("senders", "receivers", "edge_mask", "edge_norm"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)), f)
    assert (np.diff(st.receivers.numpy()[st.edge_mask.numpy()]) >= 0).all()
    assert torch.equal(st.x, gt.x)


def test_add_self_loops_and_saint_config_match_jax(rng):
    ei = rng.integers(0, 9, (2, 15)).astype(np.int64)
    got = torch_graph.add_self_loops(ei, 9)
    np.testing.assert_array_equal(got, jax_graph.add_self_loops(ei, 9))
    assert got.dtype == ei.dtype
    assert [(f.name, f.default) for f in dataclasses.fields(torch_config.SaintConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jax_config.SaintConfig)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        torch_config.SaintConfig().batch_size = 2
    assert TrainConfig is ampnet_tpu_torch.TrainConfig


@pytest.mark.parametrize("nodes,s,v6", [
    (3072, 20, False),     # the whole surrogate's bucket: K|V fits, the layer does not
    (2752, 20, True),      # the training graph's padding: K2, as paths B and D know
    (1024, 20, True), (512, 20, True), (3072, 40, False), (3072, 41, False),
    (1024, 40, True), (512, 40, True)])    # small buckets at S=40: K2 as well
def test_bucket_route_is_the_jax_predicate(nodes, s, v6):
    """At D=128, H=4 and 256-node tiles the port's mirrored dispatch picks
    the whole-layer kernel (K2) exactly where the JAX package picks v6, at
    the Predictor's padded node counts: padded to a 512-node bucket, the
    whole surrogate (3,072 nodes) at S=20 keeps K|V resident but not the
    layer, so it runs K1 where training's 2,752 nodes run K2; at S=40 the
    whole surrogate runs K1 (K|V beyond the resident budget) while buckets
    of 512 and 1,024 nodes run K2."""
    from ampnet_tpu.ops.pallas import edge_attention_fused as jeaf
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    d, h, tn = 128, 4, 256
    sp = -(-s // 8) * 8
    gather = eaf._resolve_gather("auto", nodes * sp, d, 4, tile_rows=tn * sp)
    assert gather == jeaf._resolve_gather("auto", nodes * sp, d, 4, tile_rows=tn * sp)
    ours = eaf._v6_usable(nodes, nodes, sp, d, 4, tn, eaf._auto_group(sp), gather)
    theirs = jeaf._v6_usable(nodes, nodes, sp, d, jnp.float32, tn,
                             jeaf._auto_group(sp, nodes * 4, gather), gather, num_heads=h)
    assert ours == theirs == v6
