"""The port's native GraphSAINT sampling core (``data/native.py`` over
``data/csrc/sampler.cc``) against the JAX package's: the three entry points
array-equal for the same inputs and seeds, the sampler on either core
array-equal to JAX's on the same core (norms, pad sizes, subgraphs, with
``prefetch``), the pre-pass deterministic across builds, the library built
from the port's own source into its own directory, and a failed build
raising where the JAX package falls back to numpy.

Everything here is integer arithmetic and counts: every comparison is
exact."""
import dataclasses
import subprocess
from pathlib import Path

import numpy as np
import pytest

from ampnet_tpu.data import native as jnative
from ampnet_tpu.data.graphsaint import GraphSaintRandomWalkSampler as JaxSampler
from ampnet_tpu_torch.data import graphsaint, native
from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler

ROOT = Path(__file__).resolve().parents[1]


def base_graph(seed=0, n=80, e=400, f=5):
    rng = np.random.default_rng(seed)
    x = rng.random((n, f)).astype(np.float32)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ei[:, :8] = ei[:, 8:16]                          # a few duplicate edges
    split = rng.random(n)
    return dict(x=x, edge_index=ei, y=rng.integers(0, 3, n), train_mask=split < 0.5,
                val_mask=(split >= 0.5) & (split < 0.75), test_mask=split >= 0.75)


SAMPLER = dict(batch_size=4, walk_length=6, num_steps=5, sample_coverage=8)


def assert_graphs_equal(gt, gj):
    for f in dataclasses.fields(gt):
        a, b = getattr(gt, f.name), getattr(gj, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)


@pytest.fixture(scope="module")
def csr():
    return GraphSaintRandomWalkSampler(**base_graph(), **{**SAMPLER, "sample_coverage": 0},
                                       use_native=False)


def test_entry_points_match_jax(csr):
    s = csr
    starts = np.array([0, 5, 17, 79, 3, 3])
    for seed in (0, 12345, 2**63 - 7):
        np.testing.assert_array_equal(
            native.random_walk_native(s.indptr, s.indices, starts, 9, seed),
            jnative.random_walk_native(s.indptr, s.indices, starts, 9, seed))
    ours = native.NativeInducedEdges(s._src_indptr, s._dst_sorted, s._edge_order, s.N)
    theirs = jnative.NativeInducedEdges(s._src_indptr, s._dst_sorted, s._edge_order, s.N)
    for nodes in (np.arange(0, 80, 3), np.unique(starts), np.arange(80), np.array([], int)):
        got = ours(nodes)
        np.testing.assert_array_equal(got, theirs(nodes))
        np.testing.assert_array_equal(np.sort(got), np.sort(s._induced_edge_ids(nodes)))
    with pytest.raises(ValueError, match="outside"):
        native.random_walk_native(s.indptr, s.indices, np.array([0, 80]), 3, 0)
    with pytest.raises(ValueError, match="outside"):
        ours(np.array([-1, 4]))
    args = (s.indptr, s.indices, s._src_indptr, s._dst_sorted, s._edge_order, s.N, 4, 6, 8, 5)
    for seed, threads in ((3, 0), (3, 3), (99, 8)):
        got = native.norm_prepass_native(*args, seed, num_threads=threads)
        want = jnative.norm_prepass_native(*args, seed, num_threads=threads)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        assert got[2] == want[2] > 0


@pytest.mark.parametrize("seed,coverage", [(1, 8), (6, 0)])
def test_native_sampler_matches_jax_default(seed, coverage):
    """use_native=True (the default of both): array-equal norms, pad sizes
    and the first 5 padded subgraphs, the port through prefetch."""
    base = base_graph()
    kw = {**SAMPLER, "sample_coverage": coverage, "seed": seed}
    ours, theirs = GraphSaintRandomWalkSampler(**base, **kw), JaxSampler(**base, **kw)
    assert ours.use_native and theirs._use_native
    np.testing.assert_array_equal(ours.node_norm, theirs.node_norm)
    np.testing.assert_array_equal(ours.edge_norm, theirs.edge_norm)
    assert (ours.pad_nodes_to, ours.pad_edges_to) == (theirs.pad_nodes_to, theirs.pad_edges_to)
    got = list(ours.prefetch(depth=2))
    assert len(got) == 5
    for gt, gj in zip(got, theirs):
        assert_graphs_equal(gt, gj)
    # and the numpy core of both still agrees, on another stream
    numpy_ours = GraphSaintRandomWalkSampler(**base, **kw, use_native=False)
    numpy_theirs = JaxSampler(**base, **kw, use_native=False)
    np.testing.assert_array_equal(numpy_ours.node_norm, numpy_theirs.node_norm)
    assert_graphs_equal(numpy_ours.sample(), numpy_theirs.sample())
    if coverage:
        assert not np.array_equal(numpy_ours.node_norm, ours.node_norm)


def test_two_builds_give_equal_norms(rng):
    """The port's copy of tests/test_data.py's determinism test: the
    pre-pass is a function of (graph, seed), whatever the threads'
    timing."""
    n, e = 120, 480
    x = rng.random((n, 4)).astype(np.float32)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])

    def norms():
        s = GraphSaintRandomWalkSampler(x, ei, batch_size=4, walk_length=8, num_steps=5,
                                        sample_coverage=10, seed=7)
        return s.node_norm, s.edge_norm

    (a_n, a_e), (b_n, b_e) = norms(), norms()
    np.testing.assert_array_equal(a_n, b_n)
    np.testing.assert_array_equal(a_e, b_e)


def test_library_is_the_ports_own():
    lib = Path(native.load_native()._name).resolve()
    assert lib.parent == (ROOT / "ampnet_tpu_torch" / "data" / "_build").resolve()
    assert lib.name.startswith("libampnet_sampler-")
    assert native.SRC.resolve() == ROOT / "ampnet_tpu_torch" / "data" / "csrc" / "sampler.cc"
    assert "ampnet_tpu/" not in str(lib.relative_to(ROOT))
    ignored = subprocess.run(["git", "check-ignore", "-q", str(lib)], cwd=ROOT)
    assert ignored.returncode == 0                    # .gitignore lists _build/


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that cannot run, or a source that does not
    compile, raises with the compiler's error, and so does a sampler that
    needs the library."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.load_native()
    with pytest.raises(RuntimeError, match="native sampler build failed"):
        GraphSaintRandomWalkSampler(**base_graph(), **SAMPLER)
    monkeypatch.setattr(native, "CXX", "g++")
    broken = tmp_path / "sampler.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    with pytest.raises(RuntimeError, match="exit"):
        native.build_native()
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))
    # the numpy core needs no library
    s = GraphSaintRandomWalkSampler(**base_graph(), **SAMPLER, use_native=False)
    assert s.sample().num_nodes > 0 and graphsaint.native._LIB is None
