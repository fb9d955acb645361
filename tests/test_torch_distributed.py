"""The port's parallel paths in spawned gloo groups on the CPU, held against
the JAX package under ``shard_map`` on its virtual CPU devices.

Three groups in all, each started once per module and reused for several
checks (``tests/_torch_parallel_jobs.py`` holds the ranks' side, which
imports no jax): two ranks (the edge-partitioned forward with the halo
exchange and the all-gather, plain and through the fused op's plain
versions; one partitioned SGD step through both backward routes and with
remat, plain (the lean conv, in chunks of 3 rows) and fused; what autograd
saves for the plain step's backward; one DP step; the head-parallel
forward and one TP step), four ranks
(one data x graph step with the halo and the fused op, one data x heads
step) and ``dryrun_multichip(4, device="cpu")``, which starts its own.

Sizes: 16 nodes, 48 edges, 24 features, D=8, H=2, S=6, the gcn2 head and a
precomputed scaler (JAX's ``tests/test_halo.py`` graph); graph=2 gives 8
local rows and up to 8 halo rows. The draws are JAX's, injected
(``fold_in(key, shard)``, then ``sample_present_features`` on the shard's
rows). Tolerances: log-probs rtol 1e-4 / atol 2e-5; parameters after one SGD
step within 1e-4 of each tensor's largest entry; losses rtol 1e-5."""
import numpy as np
import pytest
import torch

import _torch_parallel_jobs as jobs
from ampnet_tpu_torch.convert import flax_to_state_dict
from ampnet_tpu_torch.core.config import AMPGCNConfig as PortConfig
from ampnet_tpu_torch.ops.tokenize import fit_scaler
from ampnet_tpu_torch.parallel.launch import spawn

KW = dict(embedding_dim=8, num_heads=2, num_node_features=24, num_sampled_vectors=6,
          output_dim=3, feat_emb_dim=7, val_emb_dim=1, dropout_rate=0.0,
          dropout_adj_rate=0.0, raw_residual="gcn2", scaler="precomputed")
# DP: a config that draws nothing (every feature a token, no dropout)
DP_KW = dict(embedding_dim=8, num_heads=2, num_node_features=6, output_dim=3,
             feat_emb_dim=7, val_emb_dim=1, dropout_rate=0.0, dropout_adj_rate=0.0,
             downsample_feature_vectors=False)
LR = 0.1


def graph_arrays(seed, n=16, e=48, f=24):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, f)) < 0.3).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    y = rng.integers(0, 3, n)
    norm = (0.5 + rng.random(n)).astype(np.float32)
    return dict(x=x, edge_index=ei, y=y, train_mask=rng.random(n) < 0.7, node_norm=norm,
                pad_nodes_to=16, pad_edges_to=128)


def near_params(got, want, what):
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (what, k, err, np.abs(w).max())


@pytest.fixture(scope="module")
def ref():
    """The inputs of both packages and the JAX package's results, once."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    from ampnet_tpu.core.config import AMPGCNConfig
    from ampnet_tpu.core.graph import from_arrays
    from ampnet_tpu.models import AMPGCN
    from ampnet_tpu.ops.tokenize import sample_present_features
    from ampnet_tpu.parallel import (
        build_halo_plan, common_halo_meta, make_dp_partitioned_train_step,
        make_dp_train_step, make_mesh, make_partitioned_train_step, partition_graph,
        stack_halos, stack_partitioned)
    from ampnet_tpu.parallel.edge_partition import PartitionedGraph, amp_gcn_forward_local
    from ampnet_tpu.parallel.head_parallel import shard_map
    from ampnet_tpu.train.state import TrainState

    cfg = AMPGCNConfig(**KW)
    arrays = graph_arrays(0)
    g = from_arrays(**arrays)
    k = jax.random.PRNGKey(0)
    stats = fit_scaler(arrays["x"], np.asarray(g.node_mask))
    model = AMPGCN(config=cfg, scaler_stats=stats)
    params = jax.jit(lambda key: model.init(
        {"params": key, "sample": key, "dropout": key, "edges": key}, g,
        deterministic=True))(k)["params"]
    out = dict(inp=dict(cfg=PortConfig(**KW), state=flax_to_state_dict(params), stats=stats,
                        lr=LR, graph=arrays))

    key = jax.random.PRNGKey(3)
    pg = partition_graph(g, 2)
    plan = build_halo_plan(pg)
    part_idx = np.stack([np.asarray(sample_present_features(jax.random.fold_in(key, i),
                                                            pg.x[i], cfg.num_sampled_vectors))
                         for i in range(2)])
    out["inp"]["part_idx"] = part_idx
    mesh = make_mesh(graph=2)
    pspec = PartitionedGraph(*(P("graph") for _ in range(9)))

    def fwd(use_halo):
        def local(params, pg_in, plan_in, key):
            shard = PartitionedGraph(*(leaf[0] for leaf in pg_in))
            halo = ((plan_in.send_idx[0], plan_in.senders_ext[0], plan_in.meta, 2)
                    if use_halo else None)
            return amp_gcn_forward_local(params, shard, cfg,
                                         jax.random.fold_in(key, jax.lax.axis_index("graph")),
                                         halo=halo, scaler_stats=stats)[None]
        with mesh:
            return np.asarray(jax.jit(shard_map(
                local, mesh=mesh, in_specs=(P(), pspec, P("graph"), P()),
                out_specs=P("graph"), check_vma=False))(params, pg, plan, key))

    out["fwd_halo"] = fwd(True)
    out["fwd_allgather"] = fwd(False)

    tx = optax.sgd(LR)
    step = make_partitioned_train_step(cfg, mesh, tx, loss_mode="full", scaler_stats=stats,
                                       use_halo=True)
    with mesh:
        p2, _, m = step(params, tx.init(params), pg, key, plan)
    out["step"] = (flax_to_state_dict(jax.device_get(p2)), float(m["loss"]),
                   float(m["train_acc"]))

    # data=2 x graph=2: two replicas, each its own graph
    dp_arrays = [graph_arrays(1), graph_arrays(2)]
    out["inp"]["dp_graphs"] = dp_arrays
    pgs = [partition_graph(from_arrays(**a), 2) for a in dp_arrays]
    meta = common_halo_meta(pgs)
    halo = stack_halos([build_halo_plan(p, force_meta=meta) for p in pgs])
    out["inp"]["dp_part_idx"] = np.stack([np.stack([np.asarray(sample_present_features(
        jax.random.fold_in(jax.random.fold_in(key, di), gi), pgs[di].x[gi],
        cfg.num_sampled_vectors)) for gi in range(2)]) for di in range(2)])
    mesh4 = make_mesh(data=2, graph=2)
    step = make_dp_partitioned_train_step(cfg, mesh4, tx, loss_mode="saint",
                                          scaler_stats=stats, use_halo=True)
    with mesh4:
        p2, _, m = step(params, tx.init(params), stack_partitioned(pgs), key, halo)
    out["dp_graph_step"] = (flax_to_state_dict(jax.device_get(p2)), float(m["loss"]),
                            float(m["train_acc"]))

    # DP on data=2, a config that draws nothing
    dp_cfg = AMPGCNConfig(**DP_KW)
    plain = [dict(a, x=a["x"][:, :6].copy()) for a in dp_arrays]
    for a in plain:
        a["x"][a["x"].sum(1) == 0, 0] = 1.0
    out["inp"]["dp_plain_graphs"] = plain
    dp_graphs = [from_arrays(**a) for a in plain]
    from ampnet_tpu.parallel import shard_batch, stack_graphs
    meshd = make_mesh(data=2)
    dp_model = AMPGCN(config=dp_cfg)
    state = TrainState.create(apply_fn=dp_model.apply, tx=tx, rng=k, params=jax.jit(
        lambda key: dp_model.init({"params": key}, dp_graphs[0], deterministic=True))(k)["params"])
    out["inp"].update(dp_cfg=PortConfig(**DP_KW), dp_state=flax_to_state_dict(
        jax.device_get(state.params)))
    state2, m = make_dp_train_step(dp_model, meshd, loss_mode="saint")(
        state, shard_batch(stack_graphs(dp_graphs), meshd))
    out["dp"] = (flax_to_state_dict(jax.device_get(state2.params)), float(m["loss"]),
                 float(m["train_acc"]))

    # TP against the single-device model on one draw
    full_idx = np.asarray(sample_present_features(jax.random.PRNGKey(7), g.x,
                                                  cfg.num_sampled_vectors))
    out["inp"]["full_idx"] = full_idx

    def apply(p, graph=g, idx=full_idx):
        return model.apply({"params": p}, graph, deterministic=True, sampled_idx=idx,
                           return_aux=False).logits

    def loss_fn(p, graph, idx):
        logits = apply(p, graph, idx)
        m_ = (graph.train_mask & graph.node_mask).astype(logits.dtype)
        nll = -jnp.take_along_axis(logits, graph.y[:, None].astype(jnp.int32), axis=1)[:, 0]
        return jnp.sum(nll * m_) / jnp.maximum(jnp.sum(m_), 1.0)

    def sgd_step(p, grads):
        return flax_to_state_dict(jax.device_get(jax.tree_util.tree_map(
            lambda a, gr: a - LR * gr, p, grads)))

    out["single_fwd"] = np.asarray(jax.jit(apply)(params))
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    loss, grads = value_and_grad(params, g, full_idx)
    out["tp_step"] = (sgd_step(params, grads), float(loss))

    # DP x TP: the mean of the two replicas' losses, each its own draw
    out["inp"]["dp_full_idx"] = np.stack([np.asarray(sample_present_features(
        jax.random.fold_in(key, 10 + i), jnp.asarray(a["x"]), cfg.num_sampled_vectors))
        for i, a in enumerate(dp_arrays)])
    parts = [value_and_grad(params, from_arrays(**a), out["inp"]["dp_full_idx"][i])
             for i, a in enumerate(dp_arrays)]
    grads = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, parts[0][1], parts[1][1])
    out["dp_tp"] = (sgd_step(params, grads), float(parts[0][0] + parts[1][0]) / 2)
    return out


@pytest.fixture(scope="module")
def two(ref):
    return spawn(jobs.two_ranks, 2, ref["inp"], device="cpu")


@pytest.fixture(scope="module")
def four(ref):
    return spawn(jobs.four_ranks, 4, ref["inp"], device="cpu")


@pytest.mark.parametrize("route", ["halo", "allgather", "halo_fused", "allgather_fused"])
def test_partitioned_forward_matches_jax(ref, two, route):
    """Each rank's log-probs of its 8 local rows against JAX's shard_map
    forward (halo or all-gather; the fused op through its plain versions)."""
    want = ref["fwd_halo" if route.startswith("halo") else "fwd_allgather"]
    for rank, res in enumerate(two):
        np.testing.assert_allclose(res[f"fwd_{route}"], want[rank], rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("route", ["plain", "plain_remat", "fused", "fused_stream",
                                   "fused_remat"])
def test_partitioned_step_matches_jax(ref, two, route):
    """One SGD step over graph=2 with the halo: every rank's parameters
    against JAX's step (the fused op's backward: K3 + K4, or K5 + pass B,
    their plain versions; ``remat``: each conv recomputed in the backward,
    its exchange again; plain with ``remat``: the lean conv in chunks of 3
    rows, halo_budget_run's route); the ranks agree."""
    params, loss, acc = ref["step"]
    for res in two:
        got, _grads, got_loss, got_acc = res[f"step_{route}"]
        near_params(got, {k: v.numpy() for k, v in params.items()}, route)
        assert got_loss == pytest.approx(loss, rel=1e-5)
        assert got_acc == pytest.approx(acc, abs=1e-7)


def test_plain_remat_keeps_one_input_of_token_rows(two):
    """What autograd saves between the plain partitioned forward with the
    halo and its backward (``saved_tensors_hooks``): with ``remat`` (the
    lean conv) one tensor of token rows, conv2's [N_loc, S, D] input, and
    otherwise rows of features only (per node or per edge, no token axis):
    not the tokens, the packed q|k|v, the exchanged K|V or the per-edge
    attention rows, which the step without remat keeps."""
    n_loc, s, d, f = 8, KW["num_sampled_vectors"], KW["embedding_dim"], KW["num_node_features"]
    e_loc = 128
    for res in two:
        without, lean = res["saved"][False], res["saved"][True]
        tokens = [shape for shape, _ in lean if len(shape) >= 3 and shape[1] == s]
        assert tokens == [(n_loc, s, d)], tokens
        for shape, nbytes in lean:
            if shape not in tokens:
                assert nbytes <= 4 * max(n_loc, e_loc) * max(f, 2 * d), shape
        token_bytes = [b for shape, b in without if len(shape) >= 3 and shape[1] == s]
        assert len(token_bytes) > 4 and sum(token_bytes) > 4 * n_loc * s * d * 4


def test_timed_step_equals_untimed_and_times_each_collective(two):
    """With ``Mesh.spans`` on, the fused step takes the same parameters
    (within f32 rounding: CPU eager steps need not repeat bit for bit) and
    records seconds in the halo exchange both ways, the gradient all-reduce
    and the other all-reduces."""
    for res in two:
        params, spans = res["step_timed"]
        want = res["step_fused"][0]
        for k, v in want.items():
            np.testing.assert_allclose(params[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
        assert set(spans) == {"halo_exchange", "halo_exchange_bwd", "grad_all_reduce",
                              "all_reduce"}
        assert all(t > 0 for t in spans.values())


def test_dp_graph_step_matches_jax(ref, four):
    """data=2 x graph=2, halo, fused op: parameters, loss, accuracy."""
    params, loss, acc = ref["dp_graph_step"]
    for res in four:
        got, got_loss, got_acc = res["dp_graph"]
        near_params(got, {k: v.numpy() for k, v in params.items()}, "dp x graph")
        assert got_loss == pytest.approx(loss, rel=1e-5)
        assert got_acc == pytest.approx(acc, abs=1e-7)


def test_dp_train_step_matches_jax(ref, two):
    """data=2, each rank its own graph, 'saint' loss: the mean of the
    replicas' losses and accuracies, gradients averaged."""
    params, loss, acc = ref["dp"]
    assert [res["data_sharded"] for res in two] == [[0, 1, 2], [3, 4, 5]]
    for res in two:
        got, got_loss, got_acc = res["dp"]
        near_params(got, {k: v.numpy() for k, v in params.items()}, "dp")
        assert got_loss == pytest.approx(loss, rel=1e-5)
        assert got_acc == pytest.approx(acc, abs=1e-7)


def test_tp_forward_matches_single_device(ref, two):
    for res in two:
        np.testing.assert_allclose(res["tp_fwd"], ref["single_fwd"], rtol=1e-4, atol=2e-5)


def test_tp_step_matches_single_device_sgd(ref, two):
    """heads=2: the two ranks' head-group slices, put back together, equal
    one single-device SGD step; the replicated parameters on both ranks."""
    params, loss = ref["tp_step"]
    slices = [res["tp_step"][0] for res in two]
    near_params(unshard(slices), {k: v.numpy() for k, v in params.items()}, "tp")
    for s in slices[1:]:
        for k, v in s.items():
            if not k.startswith("conv") or k.endswith("b_out"):
                np.testing.assert_array_equal(v, slices[0][k])
    for res in two:
        assert res["tp_step"][1] == pytest.approx(loss, rel=1e-5)


def unshard(slices):
    """The ranks' head-group slices (in head order) back in the
    single-device layout."""
    from ampnet_tpu_torch.parallel import tp_unshard_params

    stacked = {k: torch.from_numpy(np.stack([s[k] for s in slices]))
               if k.split(".")[-1] in ("w_qkv", "b_qkv", "w_out") and k.startswith("conv")
               else torch.from_numpy(slices[0][k]) for k in slices[0]}
    return {k: v.numpy() for k, v in tp_unshard_params(stacked, KW["num_heads"]).items()}


def test_dp_tp_step_matches_single_device_sgd(ref, four):
    """data=2 x heads=2: each replica's two head groups put back together
    equal one SGD step on the mean of the replicas' losses; both replicas
    hold the same parameters."""
    params, loss = ref["dp_tp"]
    want = {k: v.numpy() for k, v in params.items()}
    for di in range(2):
        near_params(unshard([four[2 * di + hi]["dp_tp"][0] for hi in range(2)]), want,
                    f"dp x tp replica {di}")
    for res in four:
        assert res["dp_tp"][1] == pytest.approx(loss, rel=1e-5)


def test_dryrun_multichip_tiny_on_cpu():
    """Four ranks, data 2 x graph 2, the halo exchange and the fused op's
    plain versions: a finite loss, the same on every rank; every rank holds
    more K|V rows than queries."""
    from ampnet_tpu_torch.graft_entry import dryrun_multichip

    reports = dryrun_multichip(4, device="cpu")
    assert [r["mesh"] for r in reports] == [{"data": 2, "graph": 2}] * 4
    assert len({r["loss"] for r in reports}) == 1 and np.isfinite(reports[0]["loss"])
    assert all(r["n_all"] > r["n_loc"] for r in reports)


@pytest.mark.cuda
def test_dryrun_multichip_on_card():
    """Two gloo ranks sharing the card, the tiny flagship: K1, K3, K4 twice
    each per rank on the tensor cores."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from ampnet_tpu_torch.graft_entry import dryrun_multichip

    for r in dryrun_multichip(2, scale="tiny", device="cuda"):
        assert np.isfinite(r["loss"]) and r["backend"] == "gloo"
        for name in ("edge_attention_sums", "edge_attention_bwd_dq", "edge_attention_bwd_dkv"):
            assert r["body_launches"][name]["tc"] == 2, (name, r["body_launches"][name])
