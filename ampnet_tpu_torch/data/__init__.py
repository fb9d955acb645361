from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler, random_walk
from ampnet_tpu_torch.data.planetoid import PlanetoidData, load_cora, synthetic_cora

__all__ = ["GraphSaintRandomWalkSampler", "random_walk", "PlanetoidData",
           "load_cora", "synthetic_cora"]
