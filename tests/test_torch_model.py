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
from ampnet_tpu.ops.pallas import edge_attention_fused as jeaf
from ampnet_tpu.ops.pallas.format import compute_layout as jax_compute_layout
from ampnet_tpu.train.losses import masked_accuracy, masked_mean_nll
from ampnet_tpu.train.state import make_eval_step as jax_make_eval_step
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.models.amp_gcn import ModelOutput
from ampnet_tpu_torch.ops.hopper.format import compute_layout
from ampnet_tpu_torch.ops.tokenize import fit_scaler, tfidf_sample_features
from ampnet_tpu_torch.train import make_eval_step
from ampnet_tpu_torch.train.losses import masked_mean_nll as torch_masked_mean_nll

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
    for over in (dict(frontend="pca"), dict(compute_dtype="bfloat16"),
                 dict(downsample_feature_vectors=False)):
        with pytest.raises(NotImplementedError):
            AMPGCN(dataclasses.replace(AMPGCNConfig(**CFG), **over), device="cpu")


# ---- the model's full outputs: ModelOutput.aux, the transformer block, CLS
# pooling (against the JAX model with the same params and sampled_idx)

BLOCKS = [dict(), dict(transformer_block=True), dict(average_pooling=False),
          dict(transformer_block=True, average_pooling=False)]


def _apply_both(jm, params, tm, gj, gt, idx, use_pallas, **kw):
    jl = jax_compute_layout(gj, tile_nodes=TN) if use_pallas else None
    tl = compute_layout(gt, tile_nodes=TN) if use_pallas else None
    ref = jm.apply({"params": params}, gj, deterministic=True,
                   sampled_idx=jnp.asarray(idx), edge_layout=jl, **kw)
    return ref, tl


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("over", BLOCKS)
def test_aux_outputs_match_jax(rng, monkeypatch, over, use_pallas):
    """return_aux=True gives the JAX model's aux key by key: the injected
    sampled_idx, both convs' head-averaged attention weights (on the fused
    path from the plain weights-only pass on the side, as in JAX) and
    outputs, the pooled tokens (the mean, or the CLS token's row) and the
    raw residual; the default returns the log-prob tensor alone."""
    monkeypatch.setattr(jeaf, "_auto_group", lambda sp, emax, gather: 8)
    jm, params, tm, gj, gt = both_models(rng, use_pallas=use_pallas, **over)
    idx = rng.integers(0, F, (16, S))
    ref, tl = _apply_both(jm, params, tm, gj, gt, idx, use_pallas, return_aux=True)
    with torch.no_grad():
        got = tm(gt, sampled_idx=torch.from_numpy(idx), edge_layout=tl, return_aux=True)
        plain = tm(gt, sampled_idx=torch.from_numpy(idx), edge_layout=tl)
    assert isinstance(got, ModelOutput) and isinstance(plain, torch.Tensor)
    assert torch.equal(plain, got.logits)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), rtol=RTOL, atol=ATOL)
    assert set(got.aux) == set(ref.aux) == {
        "sampled_idx", "attn_weights_1", "attn_weights_2", "conv1_embedding",
        "conv2_embedding", "pooled", "raw_residual"}
    tokens = S + (0 if over.get("average_pooling", True) else 1)
    assert got.aux["attn_weights_1"].shape == (gt.num_edges_padded, tokens, tokens)
    for k, want in ref.aux.items():
        np.testing.assert_allclose(got.aux[k].numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    _, _, no_raw, _, _ = both_models(rng, raw_residual=False, scaler="batch", **over)
    with torch.no_grad():
        assert "raw_residual" not in no_raw(gt, sampled_idx=torch.from_numpy(idx),
                                            return_aux=True).aux


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("over", BLOCKS[1:])
def test_transformer_block_and_cls_match_jax_with_gradients(rng, over, use_pallas):
    """The pre-LN blocks (parameter-free LayerNorms at flax's epsilon,
    post_conv_linear{1,2}, ELU) and the CLS token: log-probs and every
    parameter's gradient of the masked mean NLL, deterministic=True, against
    jax.grad of the JAX model's XLA path; the port's fused path through the
    plain versions of K2 (forward without gradients) and K1 + K3/K4."""
    jm, params, tm, gj, gt = both_models(rng, use_pallas=use_pallas, **over)
    names = dict(tm.named_parameters())
    assert ("cls_token" in names) == (not over.get("average_pooling", True))
    assert ("post_conv_linear1.weight" in names) == over.get("transformer_block", False)
    idx = rng.integers(0, F, (16, S))
    train = gj.train_mask & gj.node_mask

    def loss_fn(p):
        out = jm.apply({"params": p}, gj, deterministic=True, sampled_idx=jnp.asarray(idx),
                       return_aux=False)
        return masked_mean_nll(out.logits, gj.y, train), out.logits

    (loss_j, logits_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    tl = compute_layout(gt, tile_nodes=TN) if use_pallas else None
    with torch.no_grad():
        eval_logits = tm(gt, sampled_idx=torch.from_numpy(idx), edge_layout=tl)
    logits = tm(gt, sampled_idx=torch.from_numpy(idx), edge_layout=tl)
    loss = torch_masked_mean_nll(logits, gt.y, gt.train_mask & gt.node_mask)
    loss.backward()
    for got in (eval_logits, logits.detach()):
        np.testing.assert_allclose(got.numpy(), np.asarray(logits_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    ref = flax_to_state_dict(jax.device_get(grads_j))
    assert set(ref) == set(names)
    for name, p in names.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=2e-4,
                                   atol=2e-6 * max(1.0, np.abs(r).max()), err_msg=name)
        assert np.abs(r).max() > 0, name


def test_transformer_block_parameters_and_initialization():
    """The block's Dense layers take flax's default init (lecun-normal,
    zero bias), the CLS token normal(0.02); both are drawn after every
    other parameter, so a model without them keeps its weights."""
    cfg = AMPGCNConfig(**CFG)
    base = AMPGCN(cfg, device="cpu")
    full = AMPGCN(dataclasses.replace(cfg, transformer_block=True, average_pooling=False),
                  device="cpu")
    for k, p in base.named_parameters():
        assert torch.equal(p, dict(full.named_parameters())[k]), k
    d = CFG["embedding_dim"]
    assert full.cls_token.shape == (1, 1, d) and 0.005 < float(full.cls_token.detach().std()) < 0.05
    w = full.post_conv_linear1.weight
    assert w.shape == (d, d) and float(full.post_conv_linear1.bias.abs().max()) == 0.0
    assert float(w.abs().max()) <= 2 * d ** -0.5 / 0.87962566103423978 + 1e-6
    assert not any(p.numel() == 0 for p in full.parameters())
