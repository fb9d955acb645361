"""The port's SSL heads (``ampnet_tpu_torch/train/ssl.py``) against the JAX
package's ``ampnet_tpu/train/ssl.py``.

Both sides get the same parameters (the flax tree converted by
``convert.py``), the same injected ``sampled_idx`` and the same negatives:
the JAX backbone is a subclass of its AMPGCN that passes a fixed
``sampled_idx``, and the JAX skip-gram loss draws its negatives from a
fixed key, whose draw the test makes too and hands to the port as
``neg_idx``. The JAX backbone runs its XLA convs (``use_pallas=False``);
the port runs both the fused op on a layout (the kernels' plain versions
on the CPU) and its plain path. Dropout rates are 0 with
``deterministic=False``.

Tolerances: losses rtol 1e-5; gradients within 1e-4 of each parameter's
largest entry (f32 sums in another order); after one whole step at
weight_decay > 0, parameters atol 1e-5 wherever |g + wd * p| > 1e-5 (as
``tests/test_torch_train.py``: Adam's first update is lr * g / (|g| + eps),
noise where g is). The negatives' draw is held by its distribution: only
valid nodes, and a chi-square against the uniform law at a fixed seed.
"""
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import ampnet_tpu_torch.train as port_train
from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
from ampnet_tpu.models import AMPGCN as JaxAMPGCN
from ampnet_tpu.train import ssl as jssl
from ampnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ampnet_tpu.train.state import TrainState as JaxTrainState
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.hopper.format import compute_layout
from ampnet_tpu_torch.train import create_train_state, make_optimizer
from ampnet_tpu_torch.train.ssl import (
    SSLPretrainer,
    draw_negatives,
    make_ssl_train_step,
    skipgram_loss,
)

F, S, Q, TN = 16, 4, 5, 8
CFG = dict(embedding_dim=8, num_heads=2, num_node_features=F, num_sampled_vectors=S,
           output_dim=2, feat_emb_dim=7, val_emb_dim=1, dropout_rate=0.0,
           dropout_adj_rate=0.0)
NEG_KEY = jax.random.PRNGKey(5)


class FixedDraw(JaxAMPGCN):
    """The JAX AMPGCN with its token draw injected."""

    fixed_idx: Any = None

    def __call__(self, graph, deterministic=True, return_aux=True, **kw):
        return super().__call__(graph, deterministic=deterministic, return_aux=return_aux,
                                sampled_idx=self.fixed_idx)


def graphs(rng, n=14, e=40):
    x = (rng.random((n, F)) < 0.4).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    kw = dict(y=rng.integers(0, 2, n), pad_nodes_to=16, pad_edges_to=48)
    return jax_from_arrays(x, ei, **kw), from_arrays(x, ei, **kw)


@pytest.fixture
def fixed_negatives(monkeypatch):
    """JAX's skip-gram loss, its negatives drawn from NEG_KEY; returns the
    draw it makes for a graph."""
    loss = jssl.skipgram_loss
    monkeypatch.setattr(jssl, "skipgram_loss", lambda z, s, r, m, key, q, node_mask=None:
                        loss(z, s, r, m, NEG_KEY, q, node_mask=node_mask))

    def draw(gj):
        logits = jnp.where(gj.node_mask, 0.0, -jnp.inf)
        return np.array(jax.random.categorical(
            NEG_KEY, logits[None, :], shape=(gj.senders.shape[0], Q)).astype(jnp.int32))
    return draw


def both(rng, mode, use_pallas):
    gj, gt = graphs(rng)
    idx = rng.integers(0, F, (gt.x.shape[0], S))
    jm = jssl.SSLPretrainer(backbone=FixedDraw(config=JaxConfig(**CFG),
                                               fixed_idx=jnp.asarray(idx)),
                            mode=mode, num_negatives=Q, num_features=F)
    k = jax.random.PRNGKey(0)
    params = jm.init({n: k for n in ("params", "sample", "dropout", "edges", "negatives")},
                     gj, deterministic=True)["params"]
    backbone = AMPGCN(AMPGCNConfig(**CFG, use_pallas=use_pallas), device="cpu")
    tm = SSLPretrainer(backbone, mode=mode, num_negatives=Q, num_features=F)
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    layout = compute_layout(gt, tile_nodes=TN) if use_pallas else None
    return jm, params, tm, gj, gt, idx, layout


def jax_rngs():
    k = jax.random.PRNGKey(1)
    return {n: k for n in ("sample", "dropout", "edges", "negatives")}


def test_skipgram_loss_prefers_aligned_embeddings():
    """Mirror of tests/test_ssl.py: aligned positive pairs beat anti-aligned
    ones, the negatives drawn from the same generator state."""
    base = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    senders, receivers = torch.tensor([0, 1, 2, 3]), torch.tensor([4, 5, 6, 7])
    mask = torch.ones(4, dtype=torch.bool)
    losses = []
    for z in (np.concatenate([base, base]), np.concatenate([base, -base])):
        gen = torch.Generator().manual_seed(0)
        losses.append(float(skipgram_loss(torch.from_numpy(z), senders, receivers, mask, gen)))
    assert losses[0] < losses[1]


@pytest.mark.parametrize("mode", ["contrastive", "predictive"])
def test_pretraining_decreases_loss(rng, mode):
    """Mirror of tests/test_ssl.py's _pretrain: 15 steps of the port's SSL
    step at lr 1e-2, the loss finite and falling."""
    _, gt = graphs(rng)
    backbone = AMPGCN(AMPGCNConfig(**CFG), device="cpu")
    model = SSLPretrainer(backbone, mode=mode, num_features=F)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-2), seed=1)
    step = make_ssl_train_step(model)
    losses = [float(step(state, gt)[1]["loss"]) for _ in range(15)]
    assert np.isfinite(losses).all()
    assert min(losses[5:]) < losses[0]


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("mode", ["contrastive", "predictive"])
def test_ssl_loss_and_gradients_match_jax(rng, fixed_negatives, mode, use_pallas):
    """The SSL loss and every parameter's gradient against JAX's, the same
    params, tokens and negatives; the head that the loss does not reach
    has no gradient on either side (zero in JAX)."""
    jm, params, tm, gj, gt, idx, layout = both(rng, mode, use_pallas)
    loss_j, grads_j = jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, gj, deterministic=False, rngs=jax_rngs()))(params)
    neg = fixed_negatives(gj)
    loss_t = tm(gt, deterministic=False, sampled_idx=torch.from_numpy(idx),
                generator=torch.Generator().manual_seed(0), edge_layout=layout,
                neg_idx=torch.from_numpy(neg).long() if mode == "contrastive" else None)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    ref = flax_to_state_dict(jax.device_get(grads_j))
    assert set(ref) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        r = ref[name].numpy()
        if name.startswith("backbone.final_linear_out"):
            assert p.grad is None and not r.any(), name
            continue
        assert np.abs(r).max() > 0, name
        assert np.abs(p.grad.numpy() - r).max() <= 1e-4 * np.abs(r).max(), name


def test_ssl_step_with_weight_decay_matches_jax(rng, fixed_negatives):
    """One whole step (clip 1.0, L2 1e-2, Adam) against JAX's
    make_ssl_train_step: every parameter after it, the classifier head
    (outside the loss) included: optax sees its zero gradient plus the L2
    term and moves it, and so must the port."""
    lr, wd = 1e-2, 1e-2
    jm, params, tm, gj, gt, idx, layout = both(rng, "contrastive", True)
    tx = jax_make_optimizer(lr, weight_decay=wd, grad_clip=1.0)
    jstate = JaxTrainState.create(apply_fn=jm.apply, params=params, tx=tx,
                                  rng=jax.random.PRNGKey(1))
    jstate, jmetrics = jssl.make_ssl_train_step(jm)(jstate, gj)
    grads_j = flax_to_state_dict(jax.device_get(jax.grad(lambda p: jm.apply(
        {"params": p}, gj, deterministic=False, rngs=jax_rngs()))(params)))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}

    state = create_train_state(tm, make_optimizer(tm.parameters(), lr, weight_decay=wd,
                                                  grad_clip=1.0))
    neg = torch.from_numpy(fixed_negatives(gj)).long()
    state, metrics = make_ssl_train_step(tm)(
        state, gt, layout, sampled_idx=torch.from_numpy(idx), neg_idx=neg)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    after = flax_to_state_dict(jax.device_get(jstate.params))
    for name, p in tm.named_parameters():
        g = grads_j[name].numpy() + wd * before[name].numpy()
        live = np.abs(g) > 1e-5
        np.testing.assert_allclose(p.detach().numpy()[live], after[name].numpy()[live],
                                   atol=1e-5, err_msg=name)
        assert np.abs(np.abs(p.detach().numpy() - before[name].numpy()) <= 1.01 * lr).all()
    head = tm.backbone.final_linear_out.weight
    moved = (head.detach() - before["backbone.final_linear_out.weight"]).abs()
    assert float(moved.max()) > 0.5 * lr
    assert all(int(st["step"]) == 1 for st in state.optimizer.adam.state.values())


def test_frozen_parameter_does_not_move_under_weight_decay():
    """Only trainable parameters step on a zero gradient when the loss does
    not reach them: a frozen one (``requires_grad=False``, optax's
    ``set_to_zero``) keeps no gradient, no Adam state and its value, and the
    optimizer's state still saves and loads."""
    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(3))
    b.requires_grad_(False)
    opt = make_optimizer([a, b], 1e-2, weight_decay=1e-1, grad_clip=1.0)
    opt.zero_grad()
    opt.step()
    assert b.grad is None and torch.equal(b, torch.ones(3))
    assert float((1 - a.detach()).min()) > 0
    assert b not in opt.adam.state and int(opt.adam.state[a]["step"]) == 1
    opt.load_state_dict(opt.state_dict())
    assert opt.count == 1


def test_negatives_uniform_over_valid_nodes():
    """The static-shape draw: only valid nodes, uniform over them (a
    chi-square at a fixed seed, p > 1e-3); without a mask, every node."""
    mask = torch.zeros(50, dtype=torch.bool)
    mask[torch.tensor([0, 3, 4, 9, 17, 18, 25, 31, 40, 48, 49])] = True
    gen = torch.Generator().manual_seed(0)
    neg = draw_negatives(gen, 4000, 5, 50, mask)
    assert neg.shape == (4000, 5) and neg.dtype == torch.int64
    assert bool(mask[neg].all())
    counts = torch.bincount(neg.reshape(-1), minlength=50)[mask].numpy()
    assert scipy.stats.chisquare(counts).pvalue > 1e-3
    free = draw_negatives(gen, 4000, 5, 50)
    assert int(free.min()) == 0 and int(free.max()) == 49
    assert scipy.stats.chisquare(torch.bincount(free.reshape(-1)).numpy()).pvalue > 1e-3


def test_one_generator_and_no_split_rngs(rng):
    """A difference by design: the JAX step splits its key into per-use keys
    (``split_rngs``, negatives from ``fold_in(rng, 77)``); the port's state
    carries one generator that every draw of a step advances, so
    ``ampnet_tpu_torch.train`` has no ``split_rngs``. Two steps from the
    same generator state draw the same; the next step draws anew."""
    import ampnet_tpu.train as jax_train

    assert hasattr(jax_train, "split_rngs") and not hasattr(port_train, "split_rngs")
    _, gt = graphs(rng)
    model = SSLPretrainer(AMPGCN(AMPGCNConfig(**CFG), device="cpu"), num_negatives=Q)
    state = create_train_state(model, make_optimizer(model.parameters(), 0.0), seed=3)
    start = state.generator.get_state()
    step = make_ssl_train_step(model)
    first = float(step(state, gt)[1]["loss"])
    assert not torch.equal(state.generator.get_state(), start)
    second = float(step(state, gt)[1]["loss"])
    state.generator.set_state(start)
    assert float(step(state, gt)[1]["loss"]) == first != second


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown SSL mode"):
        SSLPretrainer(AMPGCN(AMPGCNConfig(**CFG), device="cpu"), mode="masked")
