"""The port's training slice against the JAX package: AMPGCN's training
forward and every parameter gradient, one whole optimizer step (clip + L2 +
Adam) against optax, the cosine schedule, dropout and edge dropout by their
distributions, and train_full_batch on a tiny graph on the CPU.

Both models get the same parameters (converted from the flax tree) and the
same injected ``sampled_idx``, with dropout rates 0 and
``deterministic=False``: the two frameworks' random streams differ, so the
noise itself is checked by its distribution only.

Tolerances: loss and gradients rtol 2e-4 with atol 2e-6 times the
gradient's largest entry (f32, sums in another order); the optimizer alone,
fed identical gradients, atol 1e-6 on the parameters after each of three
steps; the whole step with each side's own gradients atol 1e-5 wherever
|g + wd*p| > 1e-5 (Adam's first update is lr * g / (|g| + eps): where g is
rounding noise around eps the update is noise too, and only its bound is
held)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
from ampnet_tpu.models import AMPGCN as JaxAMPGCN
from ampnet_tpu.ops.pallas import edge_attention_fused as jeaf
from ampnet_tpu.ops.pallas.format import compute_layout as jax_compute_layout
from ampnet_tpu.train.losses import masked_mean_nll as jax_masked_mean_nll
from ampnet_tpu.train.optim import cosine_warm_restarts as jax_cosine
from ampnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig, TrainConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.models.layers import dropout, dropout_edges
from ampnet_tpu_torch.ops.hopper.format import compute_layout
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.train import (
    create_train_state,
    load_checkpoint_params,
    make_optimizer,
    make_train_step,
    train_full_batch,
)
from ampnet_tpu_torch.train.checkpoint import find_latest_checkpoint, _read_payload
from ampnet_tpu_torch.train.loop import dispatch_chunk
from ampnet_tpu_torch.train.losses import masked_mean_nll

F, S, TN = 24, 4, 8
CFG = dict(embedding_dim=16, num_heads=2, num_node_features=F,
           num_sampled_vectors=S, output_dim=3, feat_emb_dim=15, val_emb_dim=1,
           token_sampling="tfidf", scaler="precomputed", raw_residual="gcn2",
           dropout_rate=0.0, dropout_adj_rate=0.0)
RECIPE = dict(learning_rate=3e-3, weight_decay=1e-3, grad_clip=1.0)


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


def jax_loss_and_grads(jm, params, gj, idx, layout=None):
    def loss_fn(p):
        k = jax.random.PRNGKey(1)
        out = jm.apply({"params": p}, gj, deterministic=False, return_aux=False,
                       sampled_idx=jnp.asarray(idx), edge_layout=layout,
                       rngs={"sample": k, "dropout": k, "edges": k})
        return jax_masked_mean_nll(out.logits, gj.y, gj.train_mask & gj.node_mask)
    return jax.value_and_grad(loss_fn)(params)


def torch_loss_and_grads(tm, gt, idx, layout=None):
    tm.zero_grad(set_to_none=True)
    logits = tm(gt, deterministic=False, sampled_idx=torch.from_numpy(idx),
                edge_layout=layout)
    loss = masked_mean_nll(logits, gt.y, gt.train_mask & gt.node_mask)
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy().copy() for k, p in tm.named_parameters()}


# ------------------------------------------------------------------ model gradients


@pytest.mark.parametrize("raw_residual,use_pallas", [
    ("gcn2", False), ("gcn2", True), ("mlp", False), (False, True)])
def test_ampgcn_loss_and_gradients_match_jax(rng, monkeypatch, raw_residual, use_pallas):
    """Training forward (deterministic=False, rates 0) and all parameter
    gradients; with use_pallas the port's backward runs K3/K4's plain
    versions and the JAX model its Pallas passes R and S in interpret mode."""
    monkeypatch.setattr(jeaf, "_auto_group", lambda sp, emax, gather: 8)
    jm, params, tm, gj, gt = both_models(
        rng, raw_residual=raw_residual, use_pallas=use_pallas,
        scaler="precomputed" if raw_residual else "batch")
    idx = rng.integers(0, F, (16, S))
    jl = jax_compute_layout(gj, tile_nodes=TN) if use_pallas else None
    tl = compute_layout(gt, tile_nodes=TN) if use_pallas else None
    loss_j, grads_j = jax_loss_and_grads(jm, params, gj, idx, jl)
    loss_t, grads_t = torch_loss_and_grads(tm, gt, idx, tl)
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-5)
    ref = flax_to_state_dict(jax.device_get(grads_j))
    assert set(ref) == set(grads_t)
    for name, g in grads_t.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-6 * max(1.0, np.abs(r).max()),
                                   err_msg=name)
        assert np.abs(r).max() > 0, name


def test_training_forward_needs_a_generator_and_draws_noise(rng):
    _, _, tm, _, gt = both_models(rng, dropout_rate=0.5, dropout_adj_rate=0.5)
    idx = torch.from_numpy(rng.integers(0, F, (16, S)))
    with pytest.raises(ValueError, match="generator"):
        tm(gt, deterministic=False, sampled_idx=idx)
    with torch.no_grad():
        calm = tm(gt, sampled_idx=idx)
        again = tm(gt, deterministic=True, sampled_idx=idx,
                   generator=torch.Generator().manual_seed(0))
        a = tm(gt, deterministic=False, sampled_idx=idx,
               generator=torch.Generator().manual_seed(0))
        b = tm(gt, deterministic=False, sampled_idx=idx,
               generator=torch.Generator().manual_seed(0))
        c = tm(gt, deterministic=False, sampled_idx=idx,
               generator=torch.Generator().manual_seed(1))
    assert torch.equal(calm, again)                 # eval applies no dropout
    assert torch.equal(a, b)                        # the generator is the only noise
    assert not torch.equal(a, c) and not torch.equal(a, calm)


def test_dropped_edges_reach_every_consumer(rng):
    """Edge dropout's mask is what both convs' validity (receiver and
    sender side), their degree counts and the GCN hops see: the fused and
    the plain path agree on a training forward and on its gradients when
    they draw the same masks."""
    _, _, tm, _, gt = both_models(rng, dropout_adj_rate=0.4, use_pallas=True)
    idx = rng.integers(0, F, (16, S))
    lay = compute_layout(gt, tile_nodes=TN)
    out = {}
    for name, layout in (("fused", lay), ("plain", None)):
        tm.zero_grad(set_to_none=True)
        logits = tm(gt, deterministic=False, sampled_idx=torch.from_numpy(idx),
                    generator=torch.Generator().manual_seed(3), edge_layout=layout)
        masked_mean_nll(logits, gt.y, gt.train_mask & gt.node_mask).backward()
        out[name] = (logits.detach(), {k: p.grad.clone() for k, p in tm.named_parameters()})
    torch.testing.assert_close(out["fused"][0], out["plain"][0], rtol=1e-4, atol=1e-5)
    for k, g in out["plain"][1].items():
        torch.testing.assert_close(out["fused"][1][k], g, rtol=2e-4,
                                   atol=2e-6 * max(1.0, float(g.abs().max())), msg=k)
    with torch.no_grad():
        kept = tm(gt, sampled_idx=torch.from_numpy(idx), edge_layout=lay)
    assert not torch.allclose(kept, out["fused"][0], atol=1e-4)   # edges were dropped


# ------------------------------------------------------------------ noise


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_dropout_keep_rate_and_scaling(rate):
    gen = torch.Generator().manual_seed(0)
    x = torch.full((400, 500), 2.0)
    y = dropout(x, rate, gen)
    kept = y != 0
    # 200,000 draws: the kept share is within 5 standard errors of 1 - rate
    assert abs(float(kept.float().mean()) - (1 - rate)) < 5 * (rate * (1 - rate) / x.numel()) ** 0.5
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0 / (1 - rate)))
    assert abs(float(y.mean()) - 2.0) < 0.02        # the expectation is kept
    assert dropout(x, 0.0, None) is x               # rate 0 draws nothing


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_edges_keep_rate_and_never_revives(rate):
    gen = torch.Generator().manual_seed(0)
    mask = torch.arange(100_000) % 4 != 0           # a quarter structurally masked
    out = dropout_edges(gen, mask, rate)
    assert out.dtype == torch.bool and not out[~mask].any()
    live = int(mask.sum())
    share = float(out[mask].float().mean())
    assert abs(share - (1 - rate)) < 5 * (rate * (1 - rate) / live) ** 0.5
    assert torch.equal(dropout_edges(torch.Generator().manual_seed(0), mask, rate), out)


# ------------------------------------------------------------------ optimizer


@pytest.mark.parametrize("grad_scale,cosine_t0", [(1.0, None), (100.0, None), (1.0, 3)])
def test_optimizer_steps_match_optax(rng, grad_scale, cosine_t0):
    """clip -> +wd*p -> Adam -> -lr over three steps with the same gradients
    on both sides (the JAX model's, scaled so that the clip is idle at 1.0
    and biting at 100), constant and cosine learning rate."""
    jm, params, tm, gj, gt = both_models(rng)
    tx = jax_make_optimizer(**RECIPE, cosine_t0=cosine_t0, cosine_t_mult=2)
    opt_state = tx.init(params)
    opt = make_optimizer(tm.parameters(), **RECIPE, cosine_t0=cosine_t0, cosine_t_mult=2)
    named = dict(tm.named_parameters())
    norms = []
    for step in range(3):
        idx = rng.integers(0, F, (16, S))
        _, grads = jax_loss_and_grads(jm, params, gj, idx)
        grads = jax.tree_util.tree_map(lambda g: g * grad_scale, grads)
        norms.append(float(optax.global_norm(grads)))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, g in flax_to_state_dict(jax.device_get(grads)).items():
            named[k].grad = g.clone()
        opt.step()
        for k, v in flax_to_state_dict(jax.device_get(params)).items():
            np.testing.assert_allclose(named[k].detach().numpy(), v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{k} after step {step}")
    assert all(n > 1.0 for n in norms) if grad_scale > 1 else all(n < 1.0 for n in norms)


def test_whole_training_step_matches_jax(rng):
    """Forward, backward and update with each side's own gradients: the
    port's make_train_step (dropout rates 0, token draw injected through the
    model) against value_and_grad + optax on the JAX model."""
    jm, params, tm, gj, gt = both_models(rng, use_pallas=False)
    idx = rng.integers(0, F, (16, S))
    tx = jax_make_optimizer(**RECIPE)
    loss_j, grads = jax_loss_and_grads(jm, params, gj, idx)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)

    state = create_train_state(tm, make_optimizer(tm.parameters(), **RECIPE), seed=0)
    forward = tm.forward
    tm.forward = lambda g, **kw: forward(g, **{**kw, "sampled_idx": torch.from_numpy(idx)})
    state, metrics = make_train_step(tm)(state, gt)
    assert state.step == 1 and set(metrics) == {"loss", "train_acc", "test_acc"}
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_j), rtol=1e-5)
    # Adam's first update is lr * g / (|g| + 1e-8) with g = grad + wd * p. The
    # key bias's gradient is 0 in exact arithmetic (a softmax ignores a
    # constant added to every score of a row) and rounding noise in f32, so
    # where |g| is not well above eps the update is noise on both sides:
    # there only its bound (lr) is held.
    decayed = jax.tree_util.tree_map(lambda g, p: g + RECIPE["weight_decay"] * p, grads, params)
    decayed = flax_to_state_dict(jax.device_get(decayed))
    before = flax_to_state_dict(jax.device_get(params))
    checked = 0
    for k, v in flax_to_state_dict(jax.device_get(new_params)).items():
        got = dict(tm.named_parameters())[k].detach()
        firm = decayed[k].abs() > 1e-5
        checked += int(firm.sum())
        np.testing.assert_allclose(got[firm].numpy(), v[firm].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
        assert float((got - before[k]).abs().max()) <= RECIPE["learning_rate"] * 1.001, k
    assert checked > 0.5 * sum(v.numel() for v in before.values())


@pytest.mark.parametrize("t_0,t_mult,eta_min", [(5, 1, 0.0), (4, 2, 1e-4)])
def test_cosine_schedule_matches_jax(t_0, t_mult, eta_min):
    p = torch.nn.Parameter(torch.zeros(3))
    opt = make_optimizer([p], learning_rate=0.1, cosine_t0=t_0, cosine_t_mult=t_mult,
                         eta_min=eta_min)
    ref = jax_cosine(0.1, t_0, t_mult, eta_min)
    for step in range(40):
        np.testing.assert_allclose(opt.learning_rate, float(ref(step)), rtol=1e-5, atol=1e-8,
                                   err_msg=f"step {step}")
        p.grad = torch.ones(3)
        opt.step()


# ------------------------------------------------------------------ the loop


def tiny_problem(seed=0, n=48, e=200):
    """Three classes, each with its own block of 8 likely features."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x = (rng.random((n, F)) < 0.1).astype(np.float32)
    for c in range(3):
        x[y == c, 8 * c: 8 * c + 8] = rng.random((int((y == c).sum()), 8)) < 0.6
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    split = rng.random(n)
    g = from_arrays(x, ei, y=y, train_mask=split < 0.5,
                    val_mask=(split >= 0.5) & (split < 0.75), test_mask=split >= 0.75,
                    pad_nodes_to=48, pad_edges_to=256)
    cfg = AMPGCNConfig(**{**CFG, "num_sampled_vectors": 5, "dropout_rate": 0.3,
                          "dropout_adj_rate": 0.1, "use_pallas": True})
    return g, lambda: AMPGCN(cfg, scaler_stats=fit_scaler(x), device="cpu")


LOOP = dict(learning_rate=1e-2, weight_decay=1e-3, cosine_t0=None, grad_clip=1.0,
            select_best_every=10, num_eval_samples=2, log_every=10, seed=0)


def test_train_full_batch_learns_selects_and_checkpoints(tmp_path):
    g, make = tiny_problem()
    cfg = TrainConfig(**LOOP, epochs=30, epochs_per_dispatch=10, run_dir=str(tmp_path))
    model = make()
    result = train_full_batch(model, g, cfg)
    hist = result["history"]
    assert [r["epoch"] for r in hist] == list(range(30))
    assert set(hist[0]) == {"loss", "train_acc", "test_acc", "epoch"}
    assert np.mean([r["loss"] for r in hist[-5:]]) < 0.8 * hist[0]["loss"]
    assert result["state"].step == 30 and result["state"].model is model
    assert set(result["final_metrics"]) == {
        f"{s}_{m}" for s in ("train", "val", "test") for m in ("acc", "loss")}
    # checkpoints on their cadence; the best one on the selection cadence
    assert sorted(os.listdir(tmp_path)) == [
        "checkpoint_best.pkl", "checkpoint_ep19.pkl", "checkpoint_ep29.pkl",
        "checkpoint_ep9.pkl", "checkpoint_final.pkl"]
    best = _read_payload(str(tmp_path / "checkpoint_best.pkl"))
    assert best["epoch"] in (9, 19, 29) and 0.0 <= best["extra"]["best_val_acc"] <= 1.0
    assert find_latest_checkpoint(str(tmp_path)).endswith("checkpoint_final.pkl")
    # final_params are the selected ones; the model keeps the last epoch's
    banked = load_checkpoint_params(str(tmp_path / "checkpoint_best.pkl"))
    for k, v in result["final_params"].items():
        assert torch.equal(v, banked[k]), k
    last = load_checkpoint_params(str(tmp_path / "checkpoint_final.pkl"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, last[k]), k


def test_chunked_dispatch_is_the_same_math_and_clips_by_gcd():
    assert dispatch_chunk(TrainConfig(epochs_per_dispatch=10, select_best_every=10)) == 10
    assert dispatch_chunk(TrainConfig(epochs_per_dispatch=10, select_best_every=4)) == 2
    assert dispatch_chunk(TrainConfig(epochs_per_dispatch=12, select_best_every=0,
                                      checkpoint_every=8)) == 12     # no run_dir
    assert dispatch_chunk(TrainConfig(epochs_per_dispatch=12, select_best_every=0,
                                      checkpoint_every=8, run_dir="x")) == 4
    assert dispatch_chunk(TrainConfig(epochs_per_dispatch=0)) == 1
    g, make = tiny_problem()
    runs = [train_full_batch(make(), g, TrainConfig(**LOOP, epochs=13, epochs_per_dispatch=k))
            for k in (1, 10)]
    assert runs[0]["history"] == runs[1]["history"] and len(runs[0]["history"]) == 13
    assert runs[0]["final_metrics"] == runs[1]["final_metrics"]


def test_resume_continues_exactly(tmp_path):
    """20 epochs, then a new process's worth of objects resumes to 30: the
    last ten epochs equal those of an uninterrupted run (parameters, Adam
    moments and the noise generator all come back from the checkpoint)."""
    g, make = tiny_problem()
    straight = train_full_batch(make(), g, TrainConfig(**LOOP, epochs=30))
    cfg = TrainConfig(**LOOP, epochs=20, run_dir=str(tmp_path))
    first = train_full_batch(make(), g, cfg)
    resumed = train_full_batch(make(), g, dataclasses.replace(cfg, epochs=30))
    assert [r["epoch"] for r in resumed["history"]] == list(range(20, 30))
    assert first["history"] + resumed["history"] == straight["history"]
    assert resumed["final_metrics"] == straight["final_metrics"]
    for k, v in straight["state"].model.state_dict().items():
        assert torch.equal(v, resumed["state"].model.state_dict()[k]), k


def test_unported_training_options_raise(tmp_path):
    """An unknown loss and the model's bfloat16 compute (not ported yet)
    raise; profile_steps, ported now, trains and writes its trace."""
    g, make = tiny_problem()
    with pytest.raises(ValueError, match="loss_mode"):
        make_train_step(make(), loss_mode="sum")
    with pytest.raises(NotImplementedError, match="float32"):
        AMPGCN(AMPGCNConfig(**{**CFG, "compute_dtype": "bfloat16"}), device="cpu")
    result = train_full_batch(make(), g, TrainConfig(**LOOP, epochs=2, profile_steps=1,
                                                     run_dir=str(tmp_path)))
    assert len(result["history"]) == 2
    assert (tmp_path / "profile" / "trace.json").is_file()
