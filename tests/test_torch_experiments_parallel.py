"""The port's drivers over ``parallel/*`` (``partitioned_graph1_timing``,
``halo_budget_run``, ``halo_comm_accounting``) on the CPU, each over
spawned gloo ranks (``parallel.launch.spawn``) at a tiny size, and the
analytic halo table against the JAX package's partitioner and halo plan.

  * partitioned_graph1_timing on a one-rank group: the partitioned step's
    first loss equals the single-device step's (same weights, same draw),
    the halo plan is empty, no byte is exchanged;
  * halo_budget_run on two ranks: a finite loss, the buffers' sizes from
    the plan, and the exchange's counted bytes equal to the plan's padded
    rows (the convs recomputed in the backward exchange again);
  * halo_comm_accounting's measured step on two ranks: the counted bytes
    of the halo exchange, the all-gather and the reduce-scatter equal the
    plan's figures.

JAX's ``halo_comm_accounting`` is not imported (its import sets
``XLA_FLAGS`` and ``jax_platforms``): its ``account`` is restated below on
``ampnet_tpu.parallel``'s ``partition_graph`` and ``build_halo_plan``.
"""
import os

import numpy as np
import pytest
import torch

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.experiments import halo_budget_run as budget
from ampnet_tpu_torch.experiments import halo_comm_accounting as halo
from ampnet_tpu_torch.experiments import partitioned_graph1_timing as timing


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here and in the ranks this module spawns: the
    suite runs six workers on the host's cores, and these small steps pay
    for every thread they wait on."""
    saved, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(saved)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


def test_graph1_timing_losses_agree_on_one_rank(monkeypatch):
    monkeypatch.setattr(timing, "NODES", 16)
    monkeypatch.setattr(timing, "EDGES", 48)
    out = timing.run(iters=1, device="cpu")
    assert out["backend"] == "gloo" and out["device"] == "cpu"
    assert out["loss_finite"] and np.isfinite(out["ratio"]) and np.isfinite(
        out["ratio_deviceloop"])
    np.testing.assert_allclose(out["loss_partitioned"], out["loss_single"], rtol=1e-5)
    # a one-rank group: its collectives move nothing, and no kernel counts
    # on the CPU (the plain versions run)
    assert set(out["moved"]) <= {"all_reduce", "grad_all_reduce"}
    assert not any(out["moved"].values())
    assert not any(out["launches"].values())
    assert (out["steps"], out["loop_steps"]) == (2, timing.LOOP_STEPS)


def test_halo_budget_run_counts_the_plan_bytes_on_two_ranks():
    out = budget.run(nodes=512, edges=128, window=8, features=8, shards=2, device="cpu")
    assert out["ok"] and np.isfinite(out["loss"]) and out["mode"] == "loss+grad step"
    assert out["budget_gb"] is None and out["over_budget"] is None and out["peak_gb"] is None
    assert out["replicated_kv_gb"] == budget.kv_gb(512)
    assert out["halo_kv_gb"] == budget.kv_gb(out["n_loc"] + out["halo_width"])
    assert out["n_loc"] == 256 and 0 < out["halo_width"] < out["n_loc"]
    row = budget.S * 2 * budget.D * 4
    for r in out["ranks"]:
        # two convs forward, recomputed once more in the backward (remat);
        # the backward exchange once per conv
        assert r["moved"]["halo_exchange"] == 4 * out["halo_width"] * row
        assert r["moved"]["halo_exchange_bwd"] == 2 * out["halo_width"] * row
        assert r["staged"] == {} and r["backend"] == "gloo"
        assert set(r["spans"]) >= {"halo_exchange", "halo_exchange_bwd", "grad_all_reduce"}
    assert 0.0 < out["exchange_share"] < 1.0


def test_measured_bytes_equal_the_plan_on_two_ranks():
    g = halo.make_graph(96, 300, window=8, seed=1)
    cfg = AMPGCNConfig(embedding_dim=16, feat_emb_dim=15, num_heads=2, num_node_features=4,
                       num_sampled_vectors=4, dropout_rate=0.0, dropout_adj_rate=0.0)
    out = halo.measured(2, "cpu", graph=g, cfg=cfg)
    plan_halo, plan_all = out["plan_halo_bytes_per_conv"], out["plan_allgather_bytes_per_conv"]
    assert 0 < plan_halo < plan_all
    for r in out["halo"]:
        assert r["moved"]["halo_exchange"] == r["moved"]["halo_exchange_bwd"] == 2 * plan_halo
        assert "all_gather" not in r["moved"] and np.isfinite(r["loss"])
    for r in out["allgather"]:
        assert r["moved"]["all_gather"] == r["moved"]["reduce_scatter"] == 2 * plan_all
        assert "halo_exchange" not in r["moved"]
    # both exchanges give the same loss: the halo moves just the rows the
    # edges name
    np.testing.assert_allclose(out["halo"][0]["loss"], out["allgather"][0]["loss"], rtol=1e-5)


def jax_account(g, p_shards):
    """experiments/halo_comm_accounting.py's ``account`` on the JAX
    package's partitioner and plan."""
    from ampnet_tpu.parallel import build_halo_plan, partition_graph

    pg = partition_graph(g, p_shards)
    plan = build_halo_plan(pg)
    n_loc = pg.x.shape[1]
    n_tot = n_loc * p_shards
    pc = np.asarray(plan.pair_counts)
    allgather_rows = (p_shards - 1) * n_loc
    halo_true_rows = int(pc.sum(axis=1).max())
    halo_padded_rows = int(sum(plan.sizes))
    rb = halo.ROW_BYTES
    return {
        "P": p_shards, "N_tot": n_tot, "live_offsets": len(plan.offsets),
        "halo_rows_per_chip": halo_padded_rows,
        "allgather_recv_MB_per_chip_per_conv": round(allgather_rows * rb / 1e6, 1),
        "halo_recv_MB_true": round(halo_true_rows * rb / 1e6, 1),
        "halo_recv_MB_padded": round(halo_padded_rows * rb / 1e6, 1),
        "reduction_x": round(allgather_rows / max(halo_padded_rows, 1), 2),
        "kv_buffer_MB_allgather": round(n_tot * rb / 1e6, 1),
        "kv_buffer_MB_halo": round((n_loc + halo_padded_rows) * rb / 1e6, 1),
    }


@pytest.mark.parametrize("n,e,window,shards", [(2708, 10556, None, 4), (3000, 20000, 128, 8),
                                               (500, 4000, 16, 2)])
def test_analytic_table_matches_jax_plans(n, e, window, shards):
    from ampnet_tpu.core.graph import from_arrays as jax_from_arrays

    g = halo.make_graph(n, e, window=window)
    rng = np.random.default_rng(0)
    recv = rng.integers(0, n, e)
    send = (recv + rng.integers(-window, window + 1, e)) % n if window else rng.integers(0, n, e)
    x = np.zeros((n, 4), np.float32)
    x[:, 0] = 1.0
    gj = jax_from_arrays(x, np.stack([send, recv]), y=np.zeros(n, np.int64),
                         train_mask=np.ones(n, bool), node_norm=np.ones(n, np.float32))
    np.testing.assert_array_equal(g.senders.numpy(), np.asarray(gj.senders))
    assert halo.account(g, shards) == jax_account(gj, shards)
