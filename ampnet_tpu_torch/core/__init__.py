from ampnet_tpu_torch.core.config import (
    AMPGCNConfig,
    AttentionConfig,
    TokenizerConfig,
    TrainConfig,
)
from ampnet_tpu_torch.core.graph import Graph, from_arrays, pad_graph

__all__ = ["AMPGCNConfig", "AttentionConfig", "TokenizerConfig", "TrainConfig",
           "Graph", "from_arrays", "pad_graph"]
