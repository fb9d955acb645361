"""Tensor parallelism over attention heads (``ampnet_tpu/parallel/head_parallel.py``
in torch): Megatron-style attention over the mesh's 'heads' axis.

  * the packed QKV in-projection is COLUMN-sharded by head group, so each
    rank projects, gathers and attends only its num_heads / n heads;
  * the output projection is ROW-sharded, so each rank's head group gives
    a partial sum of the [N, S, D] output;
  * one collective per layer forward: the all-reduce of the partial
    out-projection (plus one for the head-averaged weights when they are
    asked for).

The backward is Megatron's pair (``collectives.megatron_copy`` at the
region's entry, ``megatron_all_reduce`` at its exit): all-reduce forward
and identity backward after the out-projection; identity forward and the
all-reduce of the input's gradient before the in-projection. So the
replicated parameters (tokenizer, heads of the model, b_out) get their
whole gradient on every rank and the head-group slices their own. The
attention is the plain ``attention_core``, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ampnet_tpu_torch.ops.edge_attention import MHAParams, attention_core
from ampnet_tpu_torch.ops.gcn import gcn_aggregate
from ampnet_tpu_torch.ops.segment import segment_count, segment_sum
from ampnet_tpu_torch.ops.tokenize import (
    gather_tokens,
    sample_present_features,
    standardize,
    tfidf_sample_features,
)
from ampnet_tpu_torch.parallel.collectives import (
    all_reduce,
    all_reduce_grads,
    megatron_all_reduce,
    megatron_copy,
)
from ampnet_tpu_torch.parallel.data_parallel import shard_batch
from ampnet_tpu_torch.parallel.mesh import Mesh
from ampnet_tpu_torch.train.losses import nll_loss

_CONV_NAMES = ("conv1", "conv2")


def shard_mha_params(params: MHAParams, num_heads: int, n_shards: int) -> MHAParams:
    """MHAParams with a leading shard axis for the 'heads' mesh:
      w_qkv [n, D, 3*D/n] (columns of each of q|k|v for the shard's heads),
      b_qkv [n, 3*D/n], w_out [n, D/n, D] (rows for the shard's heads),
      b_out [n, D] (b_out / n: the sum of the partial projections adds it
      back once)."""
    d = params.w_out.shape[0]
    if num_heads % n_shards:
        raise ValueError(f"num_heads={num_heads} not divisible by n_shards={n_shards}")
    dl = (num_heads // n_shards) * (d // num_heads)
    wq, wk, wv = (params.w_qkv[:, i * d:(i + 1) * d] for i in range(3))
    bq, bk, bv = (params.b_qkv[i * d:(i + 1) * d] for i in range(3))

    def cols(w):
        return torch.stack([w[:, s * dl:(s + 1) * dl] for s in range(n_shards)])

    def vec(b):
        return torch.stack([b[s * dl:(s + 1) * dl] for s in range(n_shards)])

    return MHAParams(
        w_qkv=torch.cat([cols(wq), cols(wk), cols(wv)], dim=2),
        b_qkv=torch.cat([vec(bq), vec(bk), vec(bv)], dim=1),
        w_out=torch.stack([params.w_out[s * dl:(s + 1) * dl] for s in range(n_shards)]),
        b_out=(params.b_out / n_shards)[None].repeat(n_shards, 1))


def _head_group_conv(h, senders, receivers, edge_mask, w_qkv, b_qkv, w_out, heads_local,
                     softmax, mesh, axis):
    """One head group's message + mean, and the out-projection summed over
    ``axis``; (output [N, S, D] without b_out, count, local head-averaged
    weights)."""
    dl = w_out.shape[0]
    h = megatron_copy(h, mesh, axis)
    qkv = h @ w_qkv + b_qkv
    q = qkv[..., :dl][receivers]
    k = qkv[..., dl:2 * dl][senders]
    v = qkv[..., 2 * dl:][senders]
    msg, w_local = attention_core(q, k, v, heads_local, softmax=softmax)
    n = h.shape[0]
    total = segment_sum(msg, receivers, n, edge_mask)
    count = segment_count(receivers, n, edge_mask)
    mean = total / count.clamp_min(1.0)[:, None, None]
    return megatron_all_reduce(mean @ w_out, mesh, axis), count, w_local


def head_sharded_apply(x, senders, receivers, edge_mask, sharded_params: MHAParams,
                       num_heads: int, mesh: Mesh, softmax: bool = True,
                       return_weights: bool = True,
                       axis: str = "heads") -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The head-sharded conv given pre-sharded (stacked) params: the rank
    runs its slice. Same output [N, S, D] and head-averaged weights
    [E, S, S] as ``amp_edge_attention`` (no dropout)."""
    n_shards, i = mesh.size(axis), mesh.index(axis)
    heads_local = num_heads // n_shards
    sp = MHAParams(*(t[i] for t in sharded_params))
    out, count, w_local = _head_group_conv(x, senders, receivers, edge_mask, sp.w_qkv,
                                           sp.b_qkv, sp.w_out, heads_local, softmax, mesh,
                                           axis)
    out = out + megatron_all_reduce(sp.b_out, mesh, axis)
    out = torch.where((count > 0)[:, None, None], out, torch.zeros_like(out))
    weights = None
    if return_weights:
        # the local mean over heads_local heads, re-weighted to the global average
        weights = megatron_all_reduce(w_local * (heads_local / num_heads), mesh, axis)
    return out, weights


def head_sharded_amp_edge_attention(x, senders, receivers, edge_mask, params: MHAParams,
                                    num_heads: int, mesh: Mesh, softmax: bool = True,
                                    return_weights: bool = True, axis: str = "heads"):
    """``amp_edge_attention`` with heads sharded over ``mesh``'s ``axis``;
    ``params`` is the UNSHARDED single-device layout."""
    sharded = shard_mha_params(params, num_heads, mesh.size(axis))
    return head_sharded_apply(x, senders, receivers, edge_mask, sharded, num_heads, mesh,
                              softmax=softmax, return_weights=return_weights, axis=axis)


def tp_shard_params(state: Dict[str, torch.Tensor], num_heads: int,
                    n_shards: int) -> Dict[str, torch.Tensor]:
    """An AMPGCN state dict -> the TP layout: conv1/conv2 w_qkv, b_qkv,
    w_out replaced by shard-stacked head-group slices (``shard_mha_params``);
    b_out stays REPLICATED (Megatron: the bias is added once after the
    all-reduce); every other entry untouched."""
    out = dict(state)
    for name in _CONV_NAMES:
        sp = shard_mha_params(MHAParams(*(state[f"{name}.{k}"] for k in MHAParams._fields)),
                              num_heads, n_shards)
        for k in ("w_qkv", "b_qkv", "w_out"):
            out[f"{name}.{k}"] = getattr(sp, k)
    return out


def tp_unshard_params(state: Dict[str, torch.Tensor], num_heads: int) -> Dict[str, torch.Tensor]:
    """Inverse of ``tp_shard_params``: the head-group slices concatenated
    back into single-device MHA entries."""
    out = dict(state)
    for name in _CONV_NAMES:
        w_qkv, b_qkv = state[f"{name}.w_qkv"], state[f"{name}.b_qkv"]
        ns, dl = w_qkv.shape[0], w_qkv.shape[2] // 3
        out[f"{name}.w_qkv"] = torch.cat(
            [torch.cat([w_qkv[s, :, j * dl:(j + 1) * dl] for s in range(ns)], dim=1)
             for j in range(3)], dim=1)
        out[f"{name}.b_qkv"] = torch.cat(
            [torch.cat([b_qkv[s, j * dl:(j + 1) * dl] for s in range(ns)]) for j in range(3)])
        out[f"{name}.w_out"] = torch.cat(list(state[f"{name}.w_out"]), dim=0)
    return out


def tp_shard_model(model: nn.Module, mesh: Mesh, axis: str = "heads") -> nn.Module:
    """In place: the model's two convs keep only this rank's head-group
    slices of w_qkv, b_qkv and w_out (b_out stays whole), the layout
    ``amp_gcn_forward_heads`` and the TP steps compute with."""
    cfg = model.config
    sharded = tp_shard_params(dict(model.named_parameters()), cfg.num_heads, mesh.size(axis))
    i = mesh.index(axis)
    with torch.no_grad():
        for name in _CONV_NAMES:
            conv = getattr(model, name)
            for k in ("w_qkv", "b_qkv", "w_out"):
                setattr(conv, k, nn.Parameter(sharded[f"{name}.{k}"][i].clone()))
    return model


def amp_gcn_forward_heads(model, graph, mesh: Mesh, axis: str = "heads", scaler_stats=None,
                          generator: Optional[torch.Generator] = None,
                          sampled_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The AMPGCN forward with the convs head-sharded (deterministic: no
    dropout); ``model`` holds the rank's slices (``tp_shard_model``). The
    frontend and the heads of the model run replicated, each conv is a head
    group and one all-reduce. frontend='table', the plain stack and the
    downsampled uniform/tfidf token sampling only, as in the JAX package."""
    cfg = model.config
    if (cfg.frontend != "table" or cfg.transformer_block or not cfg.downsample_feature_vectors
            or getattr(cfg, "balanced_sampling", False)):
        raise NotImplementedError(
            "head-sharded forward supports frontend='table', plain stack, "
            "downsampled uniform/tfidf token sampling (the production configs)")
    x = graph.x
    if cfg.scaler == "precomputed":
        if scaler_stats is None:
            scaler_stats = (model.scaler_mean, model.scaler_std)
        if scaler_stats[0] is None:
            raise ValueError("cfg.scaler='precomputed' requires scaler_stats")
        x_norm = standardize(x, *(torch.as_tensor(a, device=x.device) for a in scaler_stats))
    elif cfg.scaler == "none":
        x_norm = x
    else:
        x_norm = standardize(x, node_mask=graph.node_mask)
    if sampled_idx is None:
        if cfg.token_sampling == "tfidf":
            sampled_idx = tfidf_sample_features(x, cfg.num_sampled_vectors,
                                                node_mask=graph.node_mask, generator=generator)
        else:
            sampled_idx = sample_present_features(x, cfg.num_sampled_vectors,
                                                  generator=generator)
    tokens = gather_tokens(x_norm, sampled_idx, model.tokenizer.table())
    heads_local = cfg.num_heads // mesh.size(axis)

    def conv(layer, h):
        out, count, _ = _head_group_conv(h, graph.senders, graph.receivers, graph.edge_mask,
                                         layer.w_qkv, layer.b_qkv, layer.w_out, heads_local,
                                         cfg.attn_softmax, mesh, axis)
        out = out + layer.b_out
        return torch.where((count > 0)[:, None, None], out, torch.zeros_like(out))

    h = torch.relu(conv(model.conv1, tokens))
    h = torch.relu(conv(model.conv2, h))
    pooled = h.mean(dim=1) if cfg.average_pooling else h[:, 0]
    if model.raw_mode:
        if model.raw_mode == "mlp":
            xr = torch.relu(model.raw_residual_proj(x_norm))
        else:
            def hop(gcn, z):
                out = gcn_aggregate(gcn.lin(z), graph.senders, graph.receivers, z.shape[0],
                                    graph.edge_mask, True)
                return torch.relu(out + gcn.bias)

            xr = hop(model.raw_residual_conv1, x_norm)
            if model.raw_mode == "gcn2":
                xr = hop(model.raw_residual_conv2, xr)
        pooled = torch.cat([pooled, xr], dim=-1)
    return torch.log_softmax(model.final_linear_out(pooled), dim=-1)


def _replica_loss(logp, graph, loss_mode):
    m = (graph.train_mask & graph.node_mask).to(logp.dtype)
    nll = nll_loss(logp, graph.y)
    if loss_mode == "saint":
        loss = (nll * graph.node_norm * m).sum()
    elif loss_mode == "saint_mean":
        loss = (nll * graph.node_norm * m).sum() / (graph.node_norm * m).sum().clamp_min(1e-12)
    elif loss_mode == "full":
        loss = (nll * m).sum() / m.sum().clamp_min(1.0)
    else:
        raise ValueError(f"unknown loss_mode {loss_mode!r}")
    correct = ((logp.argmax(-1) == graph.y).to(logp.dtype) * m).sum()
    return loss, correct, m.sum()


def make_tp_train_step(model, mesh: Mesh, loss_mode: str = "full", axis: str = "heads",
                       scaler_stats=None):
    """step(state, graph, sampled_idx=None) -> (state, metrics): the model
    (``tp_shard_model``) head-sharded over ``axis``, one optimizer step on
    the rank's parameters. Every rank computes the same loss; with
    Megatron's pair its gradients are already whole, so no further
    reduction over ``axis`` is made. The state's generator must draw the
    same tokens on every rank of ``axis``."""

    def step(state, graph, sampled_idx=None):
        state.optimizer.zero_grad()
        logp = amp_gcn_forward_heads(model, graph, mesh, axis, scaler_stats,
                                     generator=state.generator, sampled_idx=sampled_idx)
        loss, correct, count = _replica_loss(logp, graph, loss_mode)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(),
                       "train_acc": (correct / count.clamp_min(1.0)).detach()}

    return step


def make_dp_tp_train_step(model, mesh: Mesh, loss_mode: str = "full", data_axis: str = "data",
                          axis: str = "heads", scaler_stats=None):
    """Data-parallel x head-TP: each data replica its own graph (the
    rank's, or its entry of a stacked batch), head-sharded over ``axis``;
    the loss is the mean over replicas, so each rank differentiates its
    replica's loss over their number and the gradients are summed over
    ``data_axis``. Accuracy: correct over counted, summed over replicas."""
    n = mesh.size(data_axis)

    def step(state, graph, sampled_idx=None):
        if graph.x.dim() == 3:
            graph = shard_batch(graph, mesh)
        state.optimizer.zero_grad()
        logp = amp_gcn_forward_heads(model, graph, mesh, axis, scaler_stats,
                                     generator=state.generator, sampled_idx=sampled_idx)
        loss, correct, count = _replica_loss(logp, graph, loss_mode)
        (loss / n).backward()
        all_reduce_grads(model.parameters(), mesh, data_axis)
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            t = all_reduce(torch.stack([loss.detach(), correct, count]), mesh, data_axis)
        return state, {"loss": t[0] / n, "train_acc": t[1] / t[2].clamp_min(1.0)}

    return step
