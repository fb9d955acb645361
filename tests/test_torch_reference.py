"""chip_smoke.py's float64 reference on the CPU is float64 throughout.

Path A holds the card's logits against the same model and draw in float64 on
the CPU (``chip_smoke.cpu_f64_reference``). Its raw residual's GCN layers
used to normalize by 1/sqrt(degree) in float32 (the degrees were counted in
float32 whatever the features' type), so the "float64" reference carried
float32 edge weights, taken by the host's float32 kernels. In some
processes those came out at ~12 bits (relative error up to 3.3e-4, for
part of the nodes), which left the reference 2.65e-3 off while the card's
own stages held float64 to 2e-6. The normalization now follows the
features' type. These tests hold the float64 path against numpy in float64
(np.sqrt is correctly rounded): with float32 weights they miss by ~1e-8 of
the largest entry.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.core.graph import from_arrays
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.ops.gcn import gcn_aggregate, gcn_norm
from ampnet_tpu_torch.ops.tokenize import fit_scaler, tfidf_sample_features

F, S = 24, 5


def graph(seed=0, n=48, e=200):
    """Duplicate edges, self edges, every 7th edge masked, node n-1 isolated."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, F)) < 0.2).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0
    ei = np.stack([rng.integers(0, n - 1, e), rng.integers(0, n - 1, e)])
    ei[:, :10] = ei[:, 10:20]
    g = from_arrays(x, ei, y=rng.integers(0, 3, n), train_mask=rng.random(n) < 0.5,
                    pad_nodes_to=56, pad_edges_to=256)
    g.edge_mask = g.edge_mask.clone()
    g.edge_mask[torch.nonzero(g.edge_mask)[::7, 0]] = False
    return g, x


def numpy_gcn(h, senders, receivers, mask, n):
    """D^-1/2 (A + I) D^-1/2 h over the masked-in edges, in float64."""
    s = np.concatenate([senders[mask], np.arange(n)])
    r = np.concatenate([receivers[mask], np.arange(n)])
    deg = np.bincount(r, minlength=n).astype(np.float64)
    w = 1.0 / np.sqrt(deg[s] * deg[r])
    out = np.zeros_like(h)
    np.add.at(out, r, h[s] * w[:, None])
    return out


def close(got, want, rtol=1e-13):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gcn_weights_follow_the_requested_type(dtype):
    g, _ = graph()
    *_, w, _ = gcn_norm(g.senders, g.receivers, g.num_nodes_padded, g.edge_mask, dtype=dtype)
    assert w.dtype == dtype
    if dtype == torch.float64:
        s = np.concatenate([g.senders.numpy(), np.arange(g.num_nodes_padded)])
        r = np.concatenate([g.receivers.numpy(), np.arange(g.num_nodes_padded)])
        m = np.concatenate([g.edge_mask.numpy(), np.ones(g.num_nodes_padded, bool)])
        deg = np.bincount(r[m], minlength=g.num_nodes_padded).astype(np.float64)
        want = np.where(m, 1.0 / np.sqrt(deg[s] * deg[r]), 0.0)
        close(w.numpy(), want, 1e-15)


def test_gcn_aggregate_of_float64_features_is_float64_throughout():
    g, _ = graph()
    n = g.num_nodes_padded
    h = np.random.default_rng(1).standard_normal((n, 8)) * 10
    got = gcn_aggregate(torch.from_numpy(h), g.senders, g.receivers, n, g.edge_mask)
    assert got.dtype == torch.float64
    close(got.numpy(), numpy_gcn(h, g.senders.numpy(), g.receivers.numpy(),
                                 g.edge_mask.numpy(), n))


def test_cpu_f64_reference_raw_residual_is_float64():
    """The reference's raw residual stages (standardize, X W^T, the
    normalized aggregate, + b, for both GCN layers) against numpy in
    float64 on the same parameters and graph."""
    g, x = graph(2)
    cfg = AMPGCNConfig(embedding_dim=16, num_heads=2, num_node_features=F,
                       num_sampled_vectors=S, output_dim=3, feat_emb_dim=15, val_emb_dim=1,
                       token_sampling="tfidf", scaler="precomputed", raw_residual="gcn2",
                       dropout_rate=0.0, dropout_adj_rate=0.0, use_pallas=True)
    model = AMPGCN(cfg, scaler_stats=fit_scaler(x), device="cpu",
                   generator=torch.Generator().manual_seed(0)).eval()
    sidx = tfidf_sample_features(g.x, S, generator=torch.Generator().manual_seed(3),
                                 node_mask=g.node_mask)
    _, stages = chip_smoke.cpu_f64_reference(model, g, sidx)
    n = g.num_nodes_padded
    mean = model.scaler_mean.double().numpy()
    std = model.scaler_std.double().numpy()
    xs = (g.x.double().numpy() - mean) / np.where(std == 0.0, 1.0, std)
    args = (g.senders.numpy(), g.receivers.numpy(), g.edge_mask.numpy(), n)
    conv1, conv2 = model.raw_residual_conv1, model.raw_residual_conv2
    lin1 = xs @ conv1.lin.weight.double().detach().numpy().T
    h1 = numpy_gcn(lin1, *args) + conv1.bias.double().detach().numpy()
    close(stages["raw_residual_conv1.lin"].numpy(), lin1)
    close(stages["raw_residual_conv1"].numpy(), h1)
    lin2 = np.maximum(h1, 0.0) @ conv2.lin.weight.double().detach().numpy().T
    h2 = numpy_gcn(lin2, *args) + conv2.bias.double().detach().numpy()
    close(stages["raw_residual_conv2"].numpy(), h2)
