from ampnet_tpu_torch.core.config import AMPGCNConfig, AttentionConfig, TokenizerConfig
from ampnet_tpu_torch.core.graph import Graph, from_arrays, pad_graph

__all__ = ["AMPGCNConfig", "AttentionConfig", "TokenizerConfig", "Graph",
           "from_arrays", "pad_graph"]
