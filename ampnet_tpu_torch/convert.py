"""Convert a flax AMPGCN param tree (nested dicts of numpy arrays, as
``jax.device_get(variables['params'])`` gives) into the port's
``state_dict``, so that both packages compute with the same weights.

AMPConv parameters keep their layout; flax Dense kernels are [in, out]
and torch Linear weights [out, in], hence the transposes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map the JAX package's AMPGCN params onto the port's AMPGCN."""
    sd = {"tokenizer.feature_embedding_table":
          _t(params["tokenizer"]["feature_embedding_table"])}
    for conv in ("conv1", "conv2"):
        for name in ("w_qkv", "b_qkv", "w_out", "b_out"):
            sd[f"{conv}.{name}"] = _t(params[conv][name])
    for gcn in ("raw_residual_conv1", "raw_residual_conv2"):
        if gcn in params:
            sd[f"{gcn}.lin.weight"] = _t(params[gcn]["Dense_0"]["kernel"]).T.contiguous()
            sd[f"{gcn}.bias"] = _t(params[gcn]["bias"])
    for dense in ("raw_residual_proj", "final_linear_out"):
        if dense in params:
            sd[f"{dense}.weight"] = _t(params[dense]["kernel"]).T.contiguous()
            sd[f"{dense}.bias"] = _t(params[dense]["bias"])
    return sd
