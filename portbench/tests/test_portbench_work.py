"""The frozen work counts against numbers worked by hand, at a small shape
and at ``ampnet-cora-s40``'s."""
from __future__ import annotations

import pytest

from portbench.lib import work
from portbench.lib.manifest import load

SMALL = work.Shapes(d=4, h=2, s=2, f=5, c=3, head="gcn2", dtype="float32")


def test_small_shape_forward_by_hand():
    # N=4, E=3: qkv 2 convs x 6*4*2*16; out 2 x 2*4*2*16; edge 2 x 4*2*2*4*3;
    # gcn 2*4*5*4 + 2*4*16 + 2*2*(3+4)*4; classifier 2*4*8*3
    assert work.forward_flops(SMALL, 4, 3) == {
        "qkv": 1536, "out": 512, "edge": 384, "gcn": 400, "classifier": 192}


def test_small_shape_backward_by_hand():
    # products twice their forward; hop 1 once (raw features need no
    # gradient): 2*4*5*4 + 4*4*16 + 2*2*7*4
    assert work.backward_flops(SMALL, 4, 3) == {
        "qkv": 3072, "out": 1024, "edge": 768, "gcn": 160 + 256 + 112, "classifier": 384}


def test_small_shape_edge_attention_bytes_by_hand():
    # forward: Q, K, V read and the mean written, 4 * N*S*D * 4 B, + 2 int32 an edge
    assert work.edge_attention(SMALL, 4, 3, False) == (4 * 2 * 2 * 4 * 3, 4 * 32 * 4 + 24)
    # backward: Q, K, V, dOut read, dQ, dK, dV written
    assert work.edge_attention(SMALL, 4, 3, True) == (8 * 4 * 4 * 3, 7 * 32 * 4 + 24)
    bf16 = work.Shapes(**{**SMALL.__dict__, "dtype": "bfloat16"})
    assert work.edge_attention(bf16, 4, 3, False)[1] == 4 * 32 * 2 + 24


def test_cora_s40_counts():
    m = work.shapes(load().config("ampnet-cora-s40"))
    assert (m.d, m.h, m.s, m.f, m.c, m.dtype) == (128, 4, 40, 1433, 7, "float32")
    fwd = work.forward_flops(m, 2708, 10556)
    # Q/K/V projections 6 N S D^2 a conv: 10.65 GFLOP
    assert fwd["qkv"] / 2 == 6 * 2708 * 40 * 128 ** 2 == 10_648_289_280
    assert fwd["out"] / 2 == 2 * 2708 * 40 * 128 ** 2 == 3_549_429_760
    assert fwd["edge"] / 2 == 4 * 40 * 40 * 128 * 10556 == 8_647_475_200
    # K1's least time: bytes-bound, Q, K, V and the mean at f32: 66.2 us
    flops, nbytes = work.edge_attention(m, 2708, 10556, False)
    assert nbytes == 4 * 2708 * 40 * 128 * 4 + 2 * 10556 * 4
    assert work.least_seconds(m, flops, nbytes) == pytest.approx(nbytes / 3.35e12)
    assert work.least_seconds(m, flops, nbytes) == pytest.approx(66.25e-6, rel=1e-3)


def test_work_sums_steps_and_forwards():
    w = work.Work(steps=[(4, 3)] * 2, forwards=[(4, 3)] * 3)
    one_fwd = sum(work.forward_flops(SMALL, 4, 3).values())
    one_bwd = sum(work.backward_flops(SMALL, 4, 3).values())
    assert w.model_flops(SMALL) == 2 * (one_fwd + one_bwd) + 3 * one_fwd
    least = lambda bwd: work.least_seconds(SMALL, *work.edge_attention(SMALL, 4, 3, bwd))
    assert w.edge_attention_least_s(SMALL) == pytest.approx(
        2 * (2 * least(False) + 2 * least(True)) + 3 * 2 * least(False))


def test_peaks_are_the_published_ones():
    assert work.PEAKS["bytes_per_s"] == 3.35e12
    assert work.PEAKS["flops_per_s"] == {"float32": 495e12 / 3, "bfloat16": 989e12}
