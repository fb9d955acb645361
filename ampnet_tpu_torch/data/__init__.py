from ampnet_tpu_torch.data.planetoid import PlanetoidData, load_cora, synthetic_cora

__all__ = ["PlanetoidData", "load_cora", "synthetic_cora"]
