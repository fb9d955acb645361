"""Convert a flax param tree (nested dicts of numpy arrays, as
``jax.device_get(variables['params'])`` gives) into the port's
``state_dict``, so that both packages compute with the same weights: the
trees of AMPGCN and of the classifiers (AMPNetClassifier, GCN,
GCNOneLayer, LinearLayer, TwoLayerSigmoid). Any tree of that structure
converts the same way: a gradient tree comes out under the names of
``model.named_parameters()`` (to compare with ``.grad`` or to feed the
port's optimizer), and so does the param tree after an optax step.

AMPConv parameters, the embedding tables, the CLS and mask tokens keep
their layout; flax Dense kernels (a GCNConv's ``Dense_0`` too) are [in,
out] and torch Linear weights [out, in], hence the transposes. The
transformer block's LayerNorms have no parameters (no scale, no bias); the
PCA embeddings and scaler stats are constants, not parameters. An
``SSLPretrainer`` tree (``params['backbone']``, and in 'predictive' mode the
Dense ``feature_predictor``) maps onto ``backbone.*`` and
``feature_predictor.*``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map the JAX package's params of any of its models (or a tree shaped
    like them: gradients, updated params) onto the port's parameter names."""
    if "backbone" in params:                                 # an SSLPretrainer
        sd = {f"backbone.{k}": v for k, v in flax_to_state_dict(params["backbone"]).items()}
        if "feature_predictor" in params:
            dense = params["feature_predictor"]
            sd["feature_predictor.weight"] = _t(dense["kernel"]).T.contiguous()
            sd["feature_predictor.bias"] = _t(dense["bias"])
        return sd
    sd = {}
    if "feature_embedding_table" in params.get("tokenizer", {}):
        sd["tokenizer.feature_embedding_table"] = _t(
            params["tokenizer"]["feature_embedding_table"])
    for name in ("feature_embedding_table", "mask_token", "cls_token"):
        if name in params:
            sd[name] = _t(params[name])
    for conv in ("conv1", "conv2", "raw_residual_conv1", "raw_residual_conv2"):
        if conv not in params:
            continue
        if "Dense_0" in params[conv]:                        # a GCNConv
            sd[f"{conv}.lin.weight"] = _t(params[conv]["Dense_0"]["kernel"]).T.contiguous()
            sd[f"{conv}.bias"] = _t(params[conv]["bias"])
        else:                                                # an AMPConv
            for name in ("w_qkv", "b_qkv", "w_out", "b_out"):
                sd[f"{conv}.{name}"] = _t(params[conv][name])
    for dense in ("raw_residual_proj", "post_conv_linear1", "post_conv_linear2",
                  "final_linear_out", "linear_out", "lin1", "lin2"):
        if dense in params:
            sd[f"{dense}.weight"] = _t(params[dense]["kernel"]).T.contiguous()
            sd[f"{dense}.bias"] = _t(params[dense]["bias"])
    return sd
