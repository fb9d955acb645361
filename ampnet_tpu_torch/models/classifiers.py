"""The secondary model families and the model registry
(``ampnet_tpu/models/classifiers.py`` for the port): AMPNetClassifier, the
GCN and GCNOneLayer baselines, the XOR MLP baselines, and ``get_model``.

Reference files: src/ampnet/module/amp_net_classifier_Rahul.py,
gcn_classifier.py, gcn_one_layer.py, linear_layer.py,
two_layer_sigmoid_mlp.py; the registry at
synthetic_benchmark/xor_training_utils.py:56-103.

Each model is called as the port's steps call AMPGCN:
``model(graph, deterministic=..., generator=..., edge_layout=...)``, and
returns the output tensor, or a ``ModelOutput`` with ``return_aux=True``.
Training noise (dropout, edge dropout, GCNOneLayer's token draw) comes from
the generator; ``sampled_idx`` is taken as given where a model samples.
Parameters are made on the CPU from ``generator`` (seed 0 when None) with
the JAX package's initializers, then moved to ``device``; their names
follow the flax tree (``convert.py::flax_to_state_dict`` maps it). A
model's ``config`` names its class and options (hashable: the captured
steps key their graphs on it).

Two differences by design: the MLP baselines take their input width
(``in_dim``) at construction, where flax infers it at the first call; and
``AMPNetClassifier`` runs its convs on the fused Hopper kernels when it is
given an ``edge_layout`` (the JAX model runs XLA), on the plain path
without one.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import Graph
from ampnet_tpu_torch.models.amp_gcn import AMPGCN, ModelOutput, _lecun_normal_
from ampnet_tpu_torch.models.layers import AMPConv, GCNConv, dropout, dropout_edges
from ampnet_tpu_torch.ops.hopper.format import EdgeLayout
from ampnet_tpu_torch.ops.tokenize import balanced_sample_features, standardize


@dataclass(frozen=True)
class ClassifierConfig:
    """A classifier's class name and its options, as (name, value) pairs."""

    model: str
    options: Tuple[Tuple[str, Any], ...]


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def _dense(in_features: int, out_features: int, generator: torch.Generator) -> nn.Linear:
    """A flax Dense with its default init: lecun-normal kernel, zero bias."""
    lin = nn.Linear(in_features, out_features)
    with torch.no_grad():
        _lecun_normal_(lin, generator)
    return lin


def _needs_generator(rates, deterministic, generator):
    if not deterministic and any(r > 0.0 for r in rates) and generator is None:
        raise ValueError("deterministic=False with a dropout rate > 0 draws its masks "
                         "from an explicit generator: pass one")


def _output(out: torch.Tensor, aux: dict, return_aux: bool) -> Union[torch.Tensor, ModelOutput]:
    return ModelOutput(out, aux) if return_aux else out


class _Classifier(nn.Module):
    def _set_config(self, **options):
        self.config = ClassifierConfig(type(self).__name__, tuple(sorted(options.items())))


class AMPNetClassifier(_Classifier):
    """The early packaged model (amp_net_classifier_Rahul.py:7-57): input
    pre-embedded tokens [N, S, D] (or flattened [N, S*D], e.g. from
    ``utils.embed_features_old``); dropout -> AMPConv -> ELU, twice, then
    dropout and a linear head over the flattened tokens -> log_softmax."""

    def __init__(self, num_heads: int, embed_dim: int, n_original_features: int,
                 out_dim: int, dropout_rate: float = 0.6,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        generator = _generator(generator)
        self._set_config(num_heads=num_heads, embed_dim=embed_dim,
                         n_original_features=n_original_features, out_dim=out_dim,
                         dropout_rate=dropout_rate)
        self.num_heads, self.embed_dim = num_heads, embed_dim
        self.n_original_features, self.dropout_rate = n_original_features, dropout_rate
        self.conv1 = AMPConv(embed_dim, num_heads, use_pallas=True, generator=generator)
        self.conv2 = AMPConv(embed_dim, num_heads, use_pallas=True, generator=generator)
        self.linear_out = _dense(n_original_features * embed_dim, out_dim, generator)
        self.to(device)

    def forward(self, graph: Graph, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                edge_layout: Optional[EdgeLayout] = None, return_aux: bool = False,
                sampled_idx: Optional[torch.Tensor] = None):
        rate = 0.0 if deterministic else self.dropout_rate
        _needs_generator((rate,), deterministic, generator)
        x = graph.x
        if x.ndim == 2:
            x = x.reshape(x.shape[0], self.n_original_features, self.embed_dim)
        attns, embs = [], []
        for conv in (self.conv1, self.conv2):
            x = dropout(x, rate, generator)
            x, attn = conv(x, graph.senders, graph.receivers, graph.edge_mask,
                           return_weights=return_aux, layout=edge_layout)
            attns.append(attn)
            embs.append(x)
            x = F.elu(x)
        x = dropout(x, rate, generator)
        out = torch.log_softmax(self.linear_out(x.reshape(x.shape[0], -1)), dim=-1)
        return _output(out, {"attn_weights_1": attns[0], "attn_weights_2": attns[1],
                             "conv1_embedding": embs[0], "conv2_embedding": embs[1]},
                       return_aux)


class GCN(_Classifier):
    """The 2-layer GCN baseline over tokens (gcn_classifier.py:17-109): the
    table frontend over ALL features (no sampling), flattened [N, F*D] ->
    GCNConv -> ReLU -> dropout -> GCNConv -> log_softmax (or sigmoid).
    frontend='raw': the z-scored raw features instead of tokens.
    ``scaler_stats`` (mean, std) from ``ops.tokenize.fit_scaler``: one
    normalization at train and eval (None: refit on each batch)."""

    def __init__(self, num_node_features: int = 1433, hidden_dim: int = 16,
                 output_dim: int = 7, softmax_out: bool = True, feat_emb_dim: int = 99,
                 val_emb_dim: int = 1, dropout_rate: float = 0.1,
                 dropout_adj_rate: float = 0.1, frontend: str = "tokens",
                 scaler_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        if frontend not in ("tokens", "raw"):
            raise ValueError(f"unknown frontend {frontend!r}")
        generator = _generator(generator)
        self._set_config(num_node_features=num_node_features, hidden_dim=hidden_dim,
                         output_dim=output_dim, softmax_out=softmax_out,
                         feat_emb_dim=feat_emb_dim, val_emb_dim=val_emb_dim,
                         dropout_rate=dropout_rate, dropout_adj_rate=dropout_adj_rate,
                         frontend=frontend, scaler=scaler_stats is not None)
        self.softmax_out, self.frontend = softmax_out, frontend
        self.dropout_rate, self.dropout_adj_rate = dropout_rate, dropout_adj_rate
        f, emb_dim = num_node_features, feat_emb_dim + val_emb_dim
        if frontend == "tokens":
            self.feature_embedding_table = nn.Parameter(torch.empty(f, feat_emb_dim))
            with torch.no_grad():
                self.feature_embedding_table.normal_(generator=generator)
        self.conv1 = GCNConv(f * emb_dim if frontend == "tokens" else f, hidden_dim, generator)
        self.conv2 = GCNConv(hidden_dim, output_dim, generator)
        if scaler_stats is not None:
            mean, std = (torch.as_tensor(np.asarray(a), dtype=torch.float32)
                         for a in scaler_stats)
            self.register_buffer("scaler_mean", mean, persistent=False)
            self.register_buffer("scaler_std", std, persistent=False)
        else:
            self.scaler_mean = self.scaler_std = None
        self.to(device)

    def forward(self, graph: Graph, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                edge_layout: Optional[EdgeLayout] = None, return_aux: bool = False,
                sampled_idx: Optional[torch.Tensor] = None):
        rate = 0.0 if deterministic else self.dropout_rate
        adj_rate = 0.0 if deterministic else self.dropout_adj_rate
        _needs_generator((rate, adj_rate), deterministic, generator)
        edge_mask = graph.edge_mask
        if adj_rate > 0.0:
            edge_mask = dropout_edges(generator, edge_mask, adj_rate)
        x = standardize(graph.x, mean=self.scaler_mean, std=self.scaler_std,
                        node_mask=graph.node_mask)
        if self.frontend == "tokens":
            n, f = x.shape
            table = self.feature_embedding_table
            tokens = torch.cat([table[None].expand(n, f, table.shape[1]), x[..., None]], dim=-1)
            x = tokens.reshape(n, -1)
        x = torch.relu(self.conv1(x, graph.senders, graph.receivers, edge_mask))
        x = dropout(x, rate, generator)
        x = self.conv2(x, graph.senders, graph.receivers, edge_mask)
        out = torch.log_softmax(x, dim=-1) if self.softmax_out else torch.sigmoid(x)
        return _output(out, {}, return_aux)


class GCNOneLayer(_Classifier):
    """The 1-layer GCN over PCA-embedded, mask-token-downsampled features
    (gcn_one_layer.py:17-121; the reference's forward is disabled by an
    assert, implemented here as in the JAX package). ``pca_embedding``
    [F, feat_emb_dim] from ``ops.tokenize.pca_feature_embedding``: a
    constant buffer. Per node, a balanced draw of ``num_sampled_vectors``
    features keeps its tokens (PCA row | raw value); every other token is
    the learned mask token; the flattened tokens are z-scored over the
    whole tensor, then one GCNConv."""

    def __init__(self, pca_embedding, num_node_features: int = 1433,
                 num_sampled_vectors: int = 40, output_dim: int = 7,
                 softmax_out: bool = True, feat_emb_dim: int = 99, val_emb_dim: int = 1,
                 dropout_adj_rate: float = 0.1,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        generator = _generator(generator)
        self._set_config(num_node_features=num_node_features,
                         num_sampled_vectors=num_sampled_vectors, output_dim=output_dim,
                         softmax_out=softmax_out, feat_emb_dim=feat_emb_dim,
                         val_emb_dim=val_emb_dim, dropout_adj_rate=dropout_adj_rate)
        self.num_sampled_vectors, self.softmax_out = num_sampled_vectors, softmax_out
        self.dropout_adj_rate = dropout_adj_rate
        emb_dim = feat_emb_dim + val_emb_dim
        self.register_buffer("pca_embedding", torch.as_tensor(
            np.asarray(pca_embedding), dtype=torch.float32), persistent=False)
        self.mask_token = nn.Parameter(torch.empty(1, emb_dim))
        with torch.no_grad():
            self.mask_token.normal_(0.0, 0.02, generator=generator)
        self.conv1 = GCNConv(num_node_features * emb_dim, output_dim, generator)
        self.to(device)

    def forward(self, graph: Graph, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                edge_layout: Optional[EdgeLayout] = None, return_aux: bool = False,
                sampled_idx: Optional[torch.Tensor] = None):
        adj_rate = 0.0 if deterministic else self.dropout_adj_rate
        _needs_generator((adj_rate,), deterministic, generator)
        edge_mask = graph.edge_mask
        if adj_rate > 0.0:
            edge_mask = dropout_edges(generator, edge_mask, adj_rate)
        x = graph.x
        n, f = x.shape
        table = self.pca_embedding
        tokens = torch.cat([table[None].expand(n, f, table.shape[1]), x[..., None]], dim=-1)
        if sampled_idx is None:
            sampled_idx = balanced_sample_features(x, self.num_sampled_vectors,
                                                   generator=generator)
        keep = torch.zeros((n, f), dtype=torch.bool, device=x.device)
        keep = keep.scatter(1, sampled_idx.long(), True)
        tokens = torch.where(keep[..., None], tokens, self.mask_token[None])
        flat = tokens.reshape(n, -1)
        # the whole tensor's z-score (gcn_one_layer.py:117)
        flat = (flat - flat.mean()) / flat.std(unbiased=False).clamp_min(1e-12)
        out = self.conv1(flat, graph.senders, graph.receivers, edge_mask)
        out = torch.log_softmax(out, dim=-1) if self.softmax_out else torch.sigmoid(out)
        return _output(out, {"sampled_idx": sampled_idx}, return_aux)


class LinearLayer(_Classifier):
    """The XOR floor baseline: one Linear in_dim -> out_dim, raw logits
    (linear_layer.py:4-12; the reference's is 2 -> 1)."""

    def __init__(self, out_dim: int = 1, in_dim: int = 2,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self._set_config(out_dim=out_dim, in_dim=in_dim)
        self.lin1 = _dense(in_dim, out_dim, _generator(generator))
        self.to(device)

    def forward(self, graph: Graph, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                edge_layout: Optional[EdgeLayout] = None, return_aux: bool = False,
                sampled_idx: Optional[torch.Tensor] = None):
        return _output(self.lin1(graph.x), {}, return_aux)


class TwoLayerSigmoid(_Classifier):
    """The XOR MLP baseline: in_dim -> hidden -> sigmoid -> out_dim, raw
    logits (two_layer_sigmoid_mlp.py:5-18; the reference's is 2 -> 4 -> 1)."""

    def __init__(self, hidden_dim: int = 4, out_dim: int = 1, in_dim: int = 2,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        generator = _generator(generator)
        self._set_config(hidden_dim=hidden_dim, out_dim=out_dim, in_dim=in_dim)
        self.lin1 = _dense(in_dim, hidden_dim, generator)
        self.lin2 = _dense(hidden_dim, out_dim, generator)
        self.to(device)

    def forward(self, graph: Graph, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                edge_layout: Optional[EdgeLayout] = None, return_aux: bool = False,
                sampled_idx: Optional[torch.Tensor] = None):
        return _output(self.lin2(torch.sigmoid(self.lin1(graph.x))), {}, return_aux)


_CLASSIFIERS = {"GCN": GCN, "GCNOneLayer": GCNOneLayer, "LinearLayer": LinearLayer,
                "TwoLayerSigmoid": TwoLayerSigmoid, "AMPNetClassifier": AMPNetClassifier}
_AMPGCN_ARGS = ("scaler_stats", "generator", "device", "pca_embedding")


def get_model(name: str, **kwargs) -> nn.Module:
    """String -> configured model, the reference registry
    (synthetic_benchmark/xor_training_utils.py:56-103). 'AMPNet' is AMPGCN:
    its config fields go to AMPGCNConfig, ``scaler_stats``, ``generator``,
    ``device`` and ``pca_embedding`` to the model."""
    if name == "AMPNet":
        fields = {f.name for f in dataclasses.fields(AMPGCNConfig)}
        unknown = set(kwargs) - fields - set(_AMPGCN_ARGS)
        if unknown:
            raise TypeError(f"AMPNet takes no option(s) {sorted(unknown)}")
        return AMPGCN(AMPGCNConfig(**{k: v for k, v in kwargs.items() if k in fields}),
                      **{k: v for k, v in kwargs.items() if k in _AMPGCN_ARGS})
    if name not in _CLASSIFIERS:
        raise KeyError(f"unknown model {name!r}; choices: {sorted(['AMPNet', *_CLASSIFIERS])}")
    return _CLASSIFIERS[name](**kwargs)
