"""AMPGCN and make_eval_step of the port against the JAX package, with
the flax params converted (convert.py) and the token draws shared.

Tolerance at the model level (log-probs after two convs, two GCN hops
and the head): rtol 1e-4 / atol 1e-5 — f32, sums taken in another order;
the per-conv 2e-4 / 2e-5 of the kernel tests shrinks through the softmax
head at these widths."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
from ampnet_tpu.models import AMPGCN as JaxAMPGCN
from ampnet_tpu.ops.pallas.format import compute_layout as jax_compute_layout
from ampnet_tpu.train.losses import masked_accuracy, masked_mean_nll
from ampnet_tpu.train.state import make_eval_step as jax_make_eval_step
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.hopper.format import compute_layout
from ampnet_tpu_torch.ops.tokenize import fit_scaler, tfidf_sample_features
from ampnet_tpu_torch.train import make_eval_step

RTOL, ATOL = 1e-4, 1e-5
F, S, TN = 24, 4, 8
CFG = dict(embedding_dim=16, num_heads=2, num_node_features=F,
           num_sampled_vectors=S, output_dim=3, feat_emb_dim=15, val_emb_dim=1,
           token_sampling="tfidf", scaler="precomputed", raw_residual="gcn2")


def graphs(rng, n=14, e=40):
    x = (rng.random((n, F)) < 0.3).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 1, e)])
    split = rng.random(n)
    kw = dict(y=rng.integers(0, 3, n), train_mask=split < 0.4,
              val_mask=(split >= 0.4) & (split < 0.7), test_mask=split >= 0.7,
              pad_nodes_to=16, pad_edges_to=48)
    return x, jax_from_arrays(x, ei, **kw), from_arrays(x, ei, **kw)


def both_models(rng, **over):
    x, gj, gt = graphs(rng)
    stats = fit_scaler(x)
    jm = JaxAMPGCN(config=JaxConfig(**{**CFG, **over}), scaler_stats=stats)
    k = jax.random.PRNGKey(0)
    params = jm.init({"params": k, "sample": k, "dropout": k, "edges": k}, gj,
                     return_aux=False)["params"]
    tm = AMPGCN(AMPGCNConfig(**{**CFG, **over}), scaler_stats=stats, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    return jm, params, tm, gj, gt


@pytest.mark.parametrize("raw_residual,use_pallas", [
    ("gcn2", False), ("gcn", False), ("mlp", False), (False, False), ("gcn2", True),
])
def test_ampgcn_logits_match_jax(rng, raw_residual, use_pallas):
    jm, params, tm, gj, gt = both_models(
        rng, raw_residual=raw_residual, use_pallas=use_pallas,
        scaler="precomputed" if raw_residual else "batch")
    idx = rng.integers(0, F, (16, S))
    jl = jax_compute_layout(gj, tile_nodes=TN) if use_pallas else None
    tl = compute_layout(gt, tile_nodes=TN) if use_pallas else None
    ref = jm.apply({"params": params}, gj, deterministic=True,
                   sampled_idx=jnp.asarray(idx), return_aux=False, edge_layout=jl).logits
    with torch.no_grad():
        got = tm(gt, sampled_idx=torch.from_numpy(idx), edge_layout=tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_converted_state_covers_every_parameter(rng):
    _, params, tm, _, _ = both_models(rng)
    sd = flax_to_state_dict(jax.device_get(params))
    assert set(sd) == set(dict(tm.named_parameters()))
    assert sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(params)) == \
        sum(p.numel() for p in tm.parameters())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_eval_step_matches_jax_ensemble(rng, use_pallas):
    """The port's 3-draw eval metrics equal the JAX model's on the same
    draws: each draw replayed from a generator of the same seed."""
    jm, params, tm, gj, gt = both_models(rng, use_pallas=use_pallas)
    tl = compute_layout(gt, tile_nodes=TN) if use_pallas else None
    metrics = make_eval_step(tm, num_eval_samples=3)(
        gt, torch.Generator().manual_seed(11), tl)
    replay = torch.Generator().manual_seed(11)
    logits = []
    for _ in range(3):
        idx = tfidf_sample_features(gt.x, S, node_mask=gt.node_mask, generator=replay)
        logits.append(jm.apply({"params": params}, gj, deterministic=True,
                               sampled_idx=jnp.asarray(idx.numpy()),
                               return_aux=False).logits)
    mean = jnp.mean(jnp.stack(logits), axis=0)
    assert set(metrics) == {f"{s}_{m}" for s in ("train", "val", "test") for m in ("acc", "loss")}
    for split in ("train", "val", "test"):
        m = getattr(gj, f"{split}_mask") & gj.node_mask
        np.testing.assert_allclose(float(metrics[f"{split}_acc"]),
                                   float(masked_accuracy(mean, gj.y, m)), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(metrics[f"{split}_loss"]),
                                   float(masked_mean_nll(mean, gj.y, m)), rtol=RTOL, atol=ATOL)


def test_single_draw_eval_step_matches_jax_step_shape(rng):
    """num_eval_samples=1 returns the JAX eval step's metric keys, each a
    finite scalar."""
    jm, params, tm, gj, gt = both_models(rng)
    ours = make_eval_step(tm)(gt, torch.Generator().manual_seed(0))
    theirs = jax_make_eval_step(jm)(params, gj, jax.random.PRNGKey(0))
    assert set(ours) == set(theirs)
    assert all(v.ndim == 0 and torch.isfinite(v) for v in ours.values())


def test_unported_model_options_raise():
    for over in (dict(transformer_block=True), dict(average_pooling=False),
                 dict(frontend="pca"), dict(compute_dtype="bfloat16"),
                 dict(downsample_feature_vectors=False)):
        with pytest.raises(NotImplementedError):
            AMPGCN(dataclasses.replace(AMPGCNConfig(**CFG), **over), device="cpu")
