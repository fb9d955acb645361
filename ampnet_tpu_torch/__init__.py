"""PyTorch/CUDA port of ampnet_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports torch, never
jax, and nothing of ``ampnet_tpu``. Hand-written Hopper kernels live in
``ops/hopper/csrc`` and build with nvcc at first use. The JAX package's
classifiers (``models/classifiers.py``) are not ported yet.
"""
from ampnet_tpu_torch.core.config import (
    AMPGCNConfig,
    AttentionConfig,
    SaintConfig,
    TokenizerConfig,
    TrainConfig,
)
from ampnet_tpu_torch.core.graph import Graph, build_csr, pad_graph, sort_edges_by_receiver
from ampnet_tpu_torch.models.amp_gcn import AMPGCN
from ampnet_tpu_torch.models.layers import AMPConv, GCNConv
from ampnet_tpu_torch.serving import Predictor

__all__ = [
    "Graph",
    "pad_graph",
    "build_csr",
    "sort_edges_by_receiver",
    "AMPGCN",
    "AMPConv",
    "GCNConv",
    "AMPGCNConfig",
    "AttentionConfig",
    "TrainConfig",
    "SaintConfig",
    "TokenizerConfig",
    "Predictor",
]
