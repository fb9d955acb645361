"""Plain torch ops (the oracles of the Hopper kernels) and ops/hopper."""
from ampnet_tpu_torch.ops.edge_attention import (
    MHAParams,
    amp_edge_attention,
    attention_core,
    multihead_attention,
)
from ampnet_tpu_torch.ops.gcn import gcn_aggregate, gcn_norm
from ampnet_tpu_torch.ops.segment import (
    segment_count,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_count",
    "segment_softmax",
    "MHAParams",
    "multihead_attention",
    "attention_core",
    "amp_edge_attention",
    "gcn_norm",
    "gcn_aggregate",
]
