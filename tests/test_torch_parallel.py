"""The host side of the port's edge partition and its fused aggregate,
held against the JAX package in one process.

* ``partition_graph``, ``build_halo_plan``, ``common_halo_meta`` and
  ``partition_layouts`` (JAX's six arrays) equal JAX's bit for bit, on
  graph=2 and graph=4, with and without the halo plan; the port's walk of
  each side (``recv_ptr``/``recv_slots``, ``snd_ptr``/``snd_slots``) covers
  exactly the live slots.
* ``fused_attention_aggregate`` (K1 forward; K3 + K4, or K5 + pass B,
  backward, their plain versions here) with 8 query rows and 24 K|V rows:
  the sums and both gradients against JAX's op in interpret mode (the
  scatter-free and the stream backward), at the JAX edge group of 8 (its
  default traces for a minute); the raises for a wrong tile_nodes and a
  sender grid that does not cover the K|V rows.

Tolerances: the sums rtol 1e-5 / atol 1e-6; the gradients rtol 2e-4 with
atol 2e-5 times the gradient's largest entry (two passes over a sin
cotangent), as the port's other backward tests.

Card test (marker ``cuda``): K1, K3, K4 and K5 + pass B with more K|V rows
than query rows against their plain versions on the same card tensors."""
import numpy as np
import pytest
import torch

from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
from ampnet_tpu_torch.ops.hopper.format import build_tiled_csr, receiver_index
from ampnet_tpu_torch.parallel import (
    build_halo_plan,
    common_halo_meta,
    partition_graph,
    partition_layouts,
)

S, D, H, TN, GROUP = 4, 16, 2, 4, 8
JAX_LAYOUT = ("tile_senders", "tile_recv", "tile_valid", "snd_receivers", "snd_local",
              "snd_valid")


def graph_arrays(seed, n=40, e=150, f=12):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, f)) < 0.3).astype(np.float32)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    return dict(x=x, edge_index=ei, y=rng.integers(0, 3, n), train_mask=rng.random(n) < 0.5,
                pad_nodes_to=40, pad_edges_to=256)


@pytest.mark.parametrize("shards", [2, 4])
def test_host_partition_equals_jax(shards):
    from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
    from ampnet_tpu import parallel as jp

    arrays = [graph_arrays(s) for s in (0, 1)]
    pgs = [partition_graph(from_arrays(**a), shards) for a in arrays]
    jpgs = [jp.partition_graph(jax_from_arrays(**a), shards) for a in arrays]
    for pg, jpg in zip(pgs, jpgs):
        for name in pg._fields:
            np.testing.assert_array_equal(getattr(pg, name), np.asarray(getattr(jpg, name)),
                                          err_msg=name)
    meta = common_halo_meta(pgs)
    assert meta == jp.common_halo_meta(jpgs)
    for pg, jpg in zip(pgs, jpgs):
        for force in (None, meta):
            plan, jplan = build_halo_plan(pg, force_meta=force), jp.build_halo_plan(
                jpg, force_meta=force)
            assert plan.meta == jplan.meta
            for name in ("send_idx", "senders_ext", "pair_counts"):
                np.testing.assert_array_equal(getattr(plan, name),
                                              np.asarray(getattr(jplan, name)), err_msg=name)
            for halo in (None, plan):
                lay = partition_layouts(pg, tile_nodes=TN, halo_plan=halo)
                jlay = jp.partition_layouts(jpg, tile_nodes=TN,
                                            halo_plan=None if halo is None else jplan)
                for name in JAX_LAYOUT:
                    np.testing.assert_array_equal(getattr(lay, name),
                                                  np.asarray(getattr(jlay, name)), err_msg=name)
                # the walks visit every live slot of their side once, and nothing else
                for side, ptr, slots, valid in (("recv", lay.recv_ptr, lay.recv_slots,
                                                 lay.tile_valid),
                                                ("snd", lay.snd_ptr, lay.snd_slots,
                                                 lay.snd_valid)):
                    for i in range(shards):
                        walked = slots[i][: ptr[i][-1]]
                        np.testing.assert_array_equal(np.sort(walked),
                                                      np.flatnonzero(valid[i].reshape(-1)),
                                                      err_msg=side)


def aggregate_inputs(seed=0, n_loc=8, n_all=24, e=30):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n_loc, S, D)).astype(np.float32)
    kv = rng.normal(size=(n_all, S, 2 * D)).astype(np.float32)
    senders = rng.integers(0, n_all, e).astype(np.int32)
    receivers = np.sort(rng.integers(0, n_loc, e)).astype(np.int32)
    mask = np.ones(e, bool)
    mask[-4:] = False
    tcsr = build_tiled_csr(senders, receivers, mask, n_loc, tile_nodes=TN, group=4)
    stcsr = build_tiled_csr(receivers, senders, mask, n_all, tile_nodes=TN, group=4)
    return q, kv, tcsr, stcsr


def port_layout(tcsr, stcsr, device="cpu"):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    ptr, slots = receiver_index(tcsr.recv_local, tcsr.counts, TN)
    sptr, sslots = receiver_index(stcsr.recv_local, stcsr.counts, TN)
    return ((t(tcsr.senders), t(tcsr.valid), t(ptr), t(slots)),
            dict(snd_receivers=t(stcsr.senders), snd_valid=t(stcsr.valid), snd_ptr=t(sptr),
                 snd_slots=t(sslots)))


@pytest.fixture(scope="module")
def jax_aggregate():
    """JAX's sums and gradients (interpret mode, group 8) on both routes."""
    import jax
    import jax.numpy as jnp

    from ampnet_tpu.ops.pallas import edge_attention_fused as jeaf

    saved = jeaf._auto_group
    jeaf._auto_group = lambda sp, emax, gather: GROUP
    try:
        q, kv, tcsr, stcsr = aggregate_inputs()
        args = (jnp.asarray(tcsr.senders), jnp.asarray(tcsr.recv_local),
                jnp.asarray(tcsr.valid))
        snd = dict(snd_receivers=jnp.asarray(stcsr.senders),
                   snd_local=jnp.asarray(stcsr.recv_local), snd_valid=jnp.asarray(stcsr.valid),
                   snd_counts=jnp.asarray(stcsr.counts))
        out = {}
        for route, kw in (("scatterfree", dict(scatterfree=True, **snd)),
                          ("stream", dict(scatterfree=False))):
            def loss(qq, kk):
                sums = jeaf.fused_attention_aggregate(qq, kk, *args, num_heads=H, tile_nodes=TN,
                                                      interpret=True, **kw)
                return jnp.sum(jnp.sin(sums)), sums
            (_, sums), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
                jnp.asarray(q), jnp.asarray(kv))
            out[route] = (np.asarray(sums), [np.asarray(g) for g in grads])
        return out
    finally:
        jeaf._auto_group = saved


@pytest.mark.parametrize("route", ["scatterfree", "stream"])
def test_aggregate_matches_jax(jax_aggregate, route):
    q, kv, tcsr, stcsr = aggregate_inputs()
    walk, snd = port_layout(tcsr, stcsr)
    qt, kvt = (torch.from_numpy(a).requires_grad_() for a in (q, kv))
    sums = eaf.fused_attention_aggregate(qt, kvt, *walk, num_heads=H, tile_nodes=TN,
                                         scatterfree=route == "scatterfree", **snd)
    sums.sin().sum().backward()
    want_sums, want_grads = jax_aggregate[route]
    np.testing.assert_allclose(sums.detach().numpy(), want_sums, rtol=1e-5, atol=1e-6)
    for got, want in zip((qt.grad, kvt.grad), want_grads):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                   atol=2e-5 * np.abs(want).max())


def test_aggregate_rejects_layouts_that_do_not_fit():
    q, kv, tcsr, stcsr = aggregate_inputs()
    walk, snd = port_layout(tcsr, stcsr)
    qt, kvt = torch.from_numpy(q), torch.from_numpy(kv)
    with pytest.raises(ValueError, match="tile_nodes"):
        eaf.fused_attention_aggregate(qt, kvt, *walk, num_heads=H, tile_nodes=2 * TN)
    with pytest.raises(ValueError, match="sender layout grid"):
        eaf.fused_attention_aggregate(qt, kvt[:12], *walk, num_heads=H, tile_nodes=TN, **snd)


@pytest.mark.cuda
def test_aggregate_kernels_with_more_kv_rows_on_card():
    """K1, K3, K4 (and K5 + pass B) at 8 query rows against 24 K|V rows:
    the op's sums and gradients on the card against the same op through
    the plain versions on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, kv, tcsr, stcsr = aggregate_inputs(n_loc=40, n_all=130, e=400)
    results = {}
    for dev in ("cpu", "cuda"):
        walk, snd = port_layout(tcsr, stcsr, dev)
        for route in ("scatterfree", "stream"):
            qt, kvt = (torch.from_numpy(a).to(dev).requires_grad_() for a in (q, kv))
            sums = eaf.fused_attention_aggregate(qt, kvt, *walk, num_heads=H, tile_nodes=TN,
                                                 scatterfree=route == "scatterfree", **snd)
            sums.sin().sum().backward()
            results[dev, route] = [t.detach().cpu().numpy() for t in (sums, qt.grad, kvt.grad)]
    for route in ("scatterfree", "stream"):
        for got, want in zip(results["cuda", route], results["cpu", route]):
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5 * np.abs(want).max())


def test_ssl_transfer_probe_step_matches_optax_multi_transform():
    """The linear probe's optimizer (``experiments/ssl_transfer.py``):
    one step on gradients whose backbone norm would dominate the clip
    equals optax's ``multi_transform(train: make_optimizer(3e-3, wd 5e-4,
    clip 1.0), freeze: set_to_zero)``: the backbone does not move, the
    head's step is optax's (its clip sees the head's gradients alone)."""
    import jax
    import optax

    from ampnet_tpu.core.config import AMPGCNConfig as JaxConfig
    from ampnet_tpu.core.graph import from_arrays as jax_from_arrays
    from ampnet_tpu.models import AMPGCN as JaxAMPGCN
    from ampnet_tpu.train.optim import make_optimizer as jax_make_optimizer
    from ampnet_tpu_torch.convert import flax_to_state_dict
    from ampnet_tpu_torch.core.config import AMPGCNConfig
    from ampnet_tpu_torch.experiments.ssl_transfer import HEAD, probe_optimizer
    from ampnet_tpu_torch.models import AMPGCN

    kw = dict(embedding_dim=8, num_heads=2, num_node_features=12, num_sampled_vectors=4,
              output_dim=3, feat_emb_dim=7, val_emb_dim=1)
    a = graph_arrays(3)
    k = jax.random.PRNGKey(0)
    model = JaxAMPGCN(config=JaxConfig(**kw))
    params = jax.jit(lambda key: model.init({"params": key, "sample": key}, jax_from_arrays(**a),
                                            deterministic=True))(k)["params"]
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(
        lambda p: np.asarray(rng.normal(size=p.shape), np.float32), params)
    tx = optax.multi_transform(
        {"train": jax_make_optimizer(3e-3, weight_decay=5e-4, grad_clip=1.0),
         "freeze": optax.set_to_zero()},
        lambda ps: {n: ("train" if n == HEAD else "freeze") for n in ps})
    updates, _ = tx.update(grads, tx.init(params), params)
    want = flax_to_state_dict(jax.device_get(optax.apply_updates(params, updates)))

    port = AMPGCN(AMPGCNConfig(**kw), device="cpu")
    port.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = probe_optimizer(port)
    g = flax_to_state_dict(grads)
    for n, p in port.named_parameters():
        if p.requires_grad:
            p.grad = g[n].clone()
    opt.step()
    for n, p in port.named_parameters():
        if n.startswith(HEAD):
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6,
                                       atol=1e-7)
            assert not torch.equal(p.detach(), before[n])
        else:
            assert torch.equal(p.detach(), before[n]), n
