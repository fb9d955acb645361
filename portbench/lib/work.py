"""Operations and bytes of the work a window did, counted from shapes
(frozen: the yardstick of every roofline and utilization). Counts are of
useful work on real nodes and live edges: what the math needs, not what
an implementation recomputes or pads.

Shapes: N real nodes, E live edges, S tokens a node, D width, H heads,
F input features, C classes. One AMPConv:

* Q/K/V projection 6·N·S·D², output projection 2·N·S·D²;
* the edge-attention op on projected rows: per live edge the scores
  Q·Kᵀ (2·S²·D over the heads) and the messages P·V (2·S²·D), then the
  mean over each receiver's edges. Backward: dV, dP, dQ and dK, 2·S²·D
  each. Its bytes: Q, K, V read once and the mean written once (forward);
  Q, K, V and the output's gradient read once and dQ, dK, dV written once
  (backward); two int32 indices an edge, at the rows' element size b.

The gcn2 head: GCN hop 1 (2·N·F·D, aggregation 2·(E+N)·D), hop 2
(2·N·D², 2·(E+N)·D), the classifier 2·N·2D·C. Backward of a product is
twice its forward (input and weight gradients), once where the input needs
no gradient (hop 1 reads the raw features)."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


@dataclass(frozen=True)
class Shapes:
    d: int
    h: int
    s: int
    f: int
    c: int
    head: str           # "gcn2" or "none"
    dtype: str          # the convs' compute type: "float32" or "bfloat16"

    @property
    def b(self) -> int:
        return ELEMENT_BYTES[self.dtype]


def shapes(config: dict) -> Shapes:
    m = config["model"]
    head = m.get("raw_residual") or "none"
    if head not in ("gcn2", "none"):
        raise ValueError(f"no work count for the raw_residual head {head!r}")
    return Shapes(d=m["embedding_dim"], h=m["num_heads"], s=m["num_sampled_vectors"],
                  f=m["num_node_features"], c=m["output_dim"], head=head,
                  dtype=m.get("compute_dtype", "float32"))


def edge_attention(m: Shapes, n: float, e: float, backward: bool) -> Tuple[float, float]:
    """(FLOP, bytes) of one application of the edge-attention op."""
    rows = n * m.s * m.d * m.b
    index = 2 * e * 4
    if backward:
        return 8.0 * m.s * m.s * m.d * e, 7 * rows + index
    return 4.0 * m.s * m.s * m.d * e, 4 * rows + index


def forward_flops(m: Shapes, n: float, e: float) -> Dict[str, float]:
    """FLOP of one forward pass, by part."""
    nsd2 = n * m.s * m.d * m.d
    parts = {"qkv": 2 * 6 * nsd2, "out": 2 * 2 * nsd2,
             "edge": 2 * edge_attention(m, n, e, False)[0]}
    if m.head == "gcn2":
        parts["gcn"] = 2 * n * m.f * m.d + 2 * n * m.d * m.d + 2 * 2 * (e + n) * m.d
        parts["classifier"] = 2 * n * 2 * m.d * m.c
    else:
        parts["classifier"] = 2 * n * m.d * m.c
    return parts


def backward_flops(m: Shapes, n: float, e: float) -> Dict[str, float]:
    """FLOP of one backward pass, by part."""
    fwd = forward_flops(m, n, e)
    parts = {"qkv": 2 * fwd["qkv"], "out": 2 * fwd["out"],
             "edge": 2 * edge_attention(m, n, e, True)[0],
             "classifier": 2 * fwd["classifier"]}
    if m.head == "gcn2":
        parts["gcn"] = 2 * n * m.f * m.d + 4 * n * m.d * m.d + 2 * 2 * (e + n) * m.d
    return parts


def peak_flops(m: Shapes) -> float:
    return PEAKS["flops_per_s"][m.dtype]


def least_seconds(m: Shapes, flops: float, nbytes: float) -> float:
    """The least time the card needs: the larger of the operations over the
    peak rate of the configuration's type and the bytes over the memory
    rate."""
    return max(flops / peak_flops(m), nbytes / PEAKS["bytes_per_s"])


@dataclass
class Work:
    """What a window did: training steps (each a forward and a backward on
    ``n``, ``e`` of its own) and evaluation forwards."""

    steps: list          # [(n, e)] one entry a training step
    forwards: list       # [(n, e)] one entry an evaluation forward (a draw)

    def model_flops(self, m: Shapes) -> float:
        total = 0.0
        for n, e in self.steps:
            total += sum(forward_flops(m, n, e).values()) + sum(backward_flops(m, n, e).values())
        for n, e in self.forwards:
            total += sum(forward_flops(m, n, e).values())
        return total

    def edge_attention_least_s(self, m: Shapes) -> float:
        """The least time of every edge-attention application: two convs a
        forward, and two backward a step."""
        total = 0.0
        for n, e in self.steps:
            total += 2 * least_seconds(m, *edge_attention(m, n, e, False))
            total += 2 * least_seconds(m, *edge_attention(m, n, e, True))
        for n, e in self.forwards:
            total += 2 * least_seconds(m, *edge_attention(m, n, e, False))
        return total
