"""The port's plain torch ops against the JAX package on the same numpy
inputs: segment, tokenize, GCN and edge-attention ops.

Tolerance: exact for index results and integer counts; rtol 1e-5 /
atol 1e-6 for f32 arithmetic taken in the same order, and the conv's
rtol 2e-4 / atol 2e-5 for attention (matmuls summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.ops import edge_attention as jea
from ampnet_tpu.ops import gcn as jgcn
from ampnet_tpu.ops import segment as jseg
from ampnet_tpu.ops import tokenize as jtok
from ampnet_tpu_torch.ops import edge_attention as ea
from ampnet_tpu_torch.ops import gcn, segment, tokenize

T = torch.from_numpy


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_ops_match_jax(rng, masked):
    data = rng.normal(size=(50, 3, 4)).astype(np.float32)
    ids = rng.integers(0, 9, 50)          # segment 9 stays empty
    mask = rng.random(50) < 0.7 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else T(mask)
    close(segment.segment_sum(T(data), T(ids), 10, tm),
          jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 10, jm))
    np.testing.assert_array_equal(segment.segment_count(T(ids), 10, tm).numpy(),
                                  np.asarray(jseg.segment_count(jnp.asarray(ids), 10, jm)))
    mean = segment.segment_mean(T(data), T(ids), 10, tm)
    close(mean, jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids), 10, jm))
    assert (mean[9] == 0).all()


def test_scaler_and_standardize_match_jax(rng):
    x = (rng.random((20, 7)) * (rng.random((20, 7)) < 0.5)).astype(np.float32)
    x[:, 3] = 1.0                          # zero-variance column
    nm = rng.random(20) < 0.8
    m, s = tokenize.fit_scaler(x, nm)
    jm, js = jtok.fit_scaler(x, nm)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(s, js)
    close(tokenize.standardize(T(x), T(m), T(s)), jtok.standardize(jnp.asarray(x), jm, js))
    close(tokenize.standardize(T(x), node_mask=T(nm)),
          jtok.standardize(jnp.asarray(x), node_mask=jnp.asarray(nm)))
    close(tokenize.standardize(T(x)), jtok.standardize(jnp.asarray(x)))


def test_inverse_cdf_sample_with_shared_uniforms(rng):
    w = (rng.random((30, 50)) * (rng.random((30, 50)) < 0.3)).astype(np.float32)
    w[:, 7] += 0.5                         # every row has mass
    key = jax.random.PRNGKey(3)
    ref = jtok._inverse_cdf_sample(key, jnp.asarray(w), 12)
    u = np.array(jax.random.uniform(key, (30, 12)))
    got = tokenize._inverse_cdf_sample(T(w), 12, u=T(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (w[np.arange(30)[:, None], got.numpy()] > 0).all()
    with pytest.raises(ValueError, match="uniforms"):
        tokenize._inverse_cdf_sample(T(w), 12, u=T(u[:, :5]))


def test_samplers_match_jax_with_shared_uniforms(rng):
    x = (rng.random((24, 40)) < 0.15).astype(np.float32)
    x[5] = 0.0                             # a node with no present feature
    nm = np.arange(24) < 20                # padded rows at the end
    x[20:] = 0.0
    key = jax.random.PRNGKey(7)
    u = T(np.array(jax.random.uniform(key, (24, 9))))
    np.testing.assert_array_equal(
        tokenize.sample_present_features(T(x), 9, u=u).numpy(),
        np.asarray(jtok.sample_present_features(key, jnp.asarray(x), 9)))
    got = tokenize.tfidf_sample_features(T(x), 9, node_mask=T(nm), u=u)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jtok.tfidf_sample_features(key, jnp.asarray(x), 9,
                                              node_mask=jnp.asarray(nm))))
    # idf from the REAL node count: padding must not change the draw
    unpadded = tokenize.tfidf_sample_features(T(x[:20]), 9, u=u[:20])
    np.testing.assert_array_equal(got.numpy()[:20], unpadded.numpy())
    # a generator draws reproducibly
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    np.testing.assert_array_equal(tokenize.sample_present_features(T(x), 9, g1).numpy(),
                                  tokenize.sample_present_features(T(x), 9, g2).numpy())


def test_gather_tokens_matches_jax(rng):
    xn = rng.normal(size=(6, 10)).astype(np.float32)
    idx = rng.integers(0, 10, (6, 4))
    table = rng.normal(size=(10, 5)).astype(np.float32)
    close(tokenize.gather_tokens(T(xn), T(idx), T(table)),
          jtok.gather_tokens(jnp.asarray(xn), jnp.asarray(idx), jnp.asarray(table)))


@pytest.mark.parametrize("masked", [False, True])
def test_gcn_ops_match_jax(rng, masked):
    x = rng.normal(size=(12, 5)).astype(np.float32)
    s, r = rng.integers(0, 12, 40), rng.integers(0, 11, 40)
    mask = rng.random(40) < 0.8 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else T(mask)
    *_, w, _ = gcn.gcn_norm(T(s), T(r), 12, tm)
    *_, jw, _ = jgcn.gcn_norm(jnp.asarray(s), jnp.asarray(r), 12, jm)
    close(w, jw)
    close(gcn.gcn_aggregate(T(x), T(s), T(r), 12, tm),
          jgcn.gcn_aggregate(jnp.asarray(x), jnp.asarray(s), jnp.asarray(r), 12, jm))


def _mha(rng, d):
    p = [rng.normal(size=sh).astype(np.float32) * 0.3
         for sh in ((d, 3 * d), (3 * d,), (d, d), (d,))]
    return jea.MHAParams(*map(jnp.asarray, p)), ea.MHAParams(*map(T, p))


@pytest.mark.parametrize("softmax", [True, False])
def test_amp_edge_attention_matches_jax(rng, softmax):
    n, s, d, h = 10, 4, 16, 2
    x = rng.normal(size=(n, s, d)).astype(np.float32)
    snd, rcv = rng.integers(0, n, 30), rng.integers(0, n - 1, 30)
    mask = rng.random(30) < 0.8
    pj, pt = _mha(rng, d)
    out, w = ea.amp_edge_attention(T(x), T(snd), T(rcv), T(mask), pt, h, softmax=softmax)
    jout, jw = jea.amp_edge_attention(jnp.asarray(x), jnp.asarray(snd), jnp.asarray(rcv),
                                      jnp.asarray(mask), pj, h, softmax=softmax)
    close(out, jout, 2e-4, 2e-5)
    close(w, jw, 2e-4, 2e-5)
    assert (out[n - 1] == 0).all()          # degree-0 receiver: exact zeros
    close(ea.edge_attention_weights(T(x), T(snd), T(rcv), pt, h, softmax),
          jea.edge_attention_weights(jnp.asarray(x), jnp.asarray(snd), jnp.asarray(rcv),
                                     pj, h, softmax), 2e-4, 2e-5)
    q = rng.normal(size=(7, s, d)).astype(np.float32)
    a, aw = ea.attention_core(T(q), T(q), T(q), h, softmax)
    ja, jaw = jea.attention_core(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), h, softmax)
    close(a, ja, 2e-4, 2e-5)
    close(aw, jaw, 2e-4, 2e-5)
