"""PyTorch/CUDA port of ampnet_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports torch, never
jax, and nothing of ``ampnet_tpu``. Hand-written Hopper kernels live in
``ops/hopper/csrc`` and build with nvcc at first use; the GraphSAINT
sampler's native core lives in ``data/csrc`` and builds with g++ at first
use. Besides AMPGCN it holds the JAX package's other models
(``models/classifiers.py``: AMPNetClassifier, GCN, GCNOneLayer, the XOR MLP
baselines and ``get_model``) and its synthetic datasets
(``data/synthetic.py``).
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
from ampnet_tpu_torch.models.classifiers import (
    GCN,
    AMPNetClassifier,
    GCNOneLayer,
    LinearLayer,
    TwoLayerSigmoid,
)
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
    "AMPNetClassifier",
    "GCN",
    "GCNOneLayer",
    "LinearLayer",
    "TwoLayerSigmoid",
    "AMPGCNConfig",
    "AttentionConfig",
    "TrainConfig",
    "SaintConfig",
    "TokenizerConfig",
    "Predictor",
]
