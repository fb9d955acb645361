from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler, random_walk
from ampnet_tpu_torch.data.planetoid import (
    PlanetoidData,
    load_cora,
    load_planetoid_raw,
    synthetic_cora,
)
from ampnet_tpu_torch.data.synthetic import (
    create_duplicated_xor_data,
    create_xor_data,
    get_duplicated_xor_graphs,
    get_xor_graphs,
    make_rpg_graph,
    random_partition_graph,
    rpg_rgb_features,
)

__all__ = [
    "create_xor_data",
    "create_duplicated_xor_data",
    "random_partition_graph",
    "rpg_rgb_features",
    "make_rpg_graph",
    "get_xor_graphs",
    "get_duplicated_xor_graphs",
    "GraphSaintRandomWalkSampler",
    "random_walk",
    "PlanetoidData",
    "load_cora",
    "load_planetoid_raw",
    "synthetic_cora",
]
