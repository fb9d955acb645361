from ampnet_tpu_torch.models.amp_gcn import AMPGCN, ModelOutput
from ampnet_tpu_torch.models.classifiers import (
    GCN,
    AMPNetClassifier,
    GCNOneLayer,
    LinearLayer,
    TwoLayerSigmoid,
    get_model,
)
from ampnet_tpu_torch.models.layers import AMPConv, GCNConv, dropout_edges
from ampnet_tpu_torch.models.tokenizer import FeatureTokenizer

__all__ = [
    "AMPGCN",
    "ModelOutput",
    "AMPConv",
    "GCNConv",
    "dropout_edges",
    "FeatureTokenizer",
    "AMPNetClassifier",
    "GCN",
    "GCNOneLayer",
    "LinearLayer",
    "TwoLayerSigmoid",
    "get_model",
]
