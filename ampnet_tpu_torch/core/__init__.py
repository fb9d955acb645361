from ampnet_tpu_torch.core.config import (
    AMPGCNConfig,
    AttentionConfig,
    SaintConfig,
    TokenizerConfig,
    TrainConfig,
)
from ampnet_tpu_torch.core.graph import (
    Graph,
    add_self_loops,
    build_csr,
    from_arrays,
    pad_graph,
    sort_edges_by_receiver,
)

__all__ = ["AMPGCNConfig", "AttentionConfig", "SaintConfig", "TokenizerConfig",
           "TrainConfig", "Graph", "add_self_loops", "build_csr", "from_arrays",
           "pad_graph", "sort_edges_by_receiver"]
