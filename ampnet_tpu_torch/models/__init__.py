from ampnet_tpu_torch.models.amp_gcn import AMPGCN
from ampnet_tpu_torch.models.layers import AMPConv, GCNConv

__all__ = ["AMPGCN", "AMPConv", "GCNConv"]
