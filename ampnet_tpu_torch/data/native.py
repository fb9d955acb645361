"""ctypes bindings for the native sampling core (``data/csrc/sampler.cc``),
the port's copy of ``ampnet_tpu/data/native.py``: the same functions, the
same signatures and the same C entry points, so that one seed gives the
same walks, induced edges and normalization counts in both packages.

The library builds with g++ at first use, with the JAX package's flags,
into ``_build/`` beside this file (``.gitignore`` lists it). Its file name
carries a digest of the source, the flags and the host, so an edited
source is rebuilt, a stale build is never loaded, and a build for another
machine's CPU (``-march=native``) is not either; each build goes to a per-process
temporary file and is renamed into place, so concurrent first uses (xdist
workers, several processes) never load a half-written library.

Unlike the JAX package, nothing falls back to numpy here: a library that
does not build or load raises, with the compiler's error. The numpy core is
chosen explicitly (``GraphSaintRandomWalkSampler(use_native=False)``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).parent / "csrc" / "sampler.cc"
BUILD_DIR = Path(__file__).parent / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]
# the pre-pass's thread count when none is given: FIXED, not the host's
# core count, since the set of samples the deterministic chunked pre-pass
# processes depends on it (another count, other norms for the same seed)
DEFAULT_THREADS = 8

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _lib_path() -> Path:
    """The library's path: a digest of the source, the flags and the host
    (-march=native builds for this host's CPU only)."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(" ".join(os.uname()).encode())
    return BUILD_DIR / f"libampnet_sampler-{h.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> str:
    """Compile the sampler library unless a build of this source and these
    flags exists (``force``: compile anyway). Returns its path; raises
    RuntimeError with the compiler's output when the build fails."""
    lib = _lib_path()
    if lib.exists() and not force:
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as e:          # no compiler at that path
        raise RuntimeError(f"native sampler build failed: cannot run {CXX!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native sampler build failed: {CXX} exit {proc.returncode}\n"
                           f"{proc.stderr.strip()}")
    os.replace(tmp, lib)          # atomic: a concurrent loader sees all or nothing
    return str(lib)


def load_native(auto_build: bool = True) -> ctypes.CDLL:
    """The loaded library (built first when ``auto_build``); raises when it
    cannot be built or loaded."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        path = build_native() if auto_build else str(_lib_path())
        if not os.path.exists(path):
            raise RuntimeError(f"native sampler library {path} is not built")
        lib = ctypes.CDLL(path)

        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.ampnet_random_walk.argtypes = [
            i64p, i32p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, i64p,
        ]
        lib.ampnet_random_walk.restype = None
        lib.ampnet_induced_edges.argtypes = [
            i64p, ctypes.c_int64, u8p, ctypes.c_int64, i64p, i32p, i64p,
            i64p, ctypes.c_int64,
        ]
        lib.ampnet_induced_edges.restype = ctypes.c_int64
        lib.ampnet_norm_prepass.argtypes = [
            i64p, i32p, ctypes.c_int64, i64p, i32p, i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_int64, f64p, f64p,
        ]
        lib.ampnet_norm_prepass.restype = ctypes.c_int64
        _LIB = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check_nodes(nodes: np.ndarray, n: int, what: str) -> None:
    """The C code indexes [0, n) arrays by these ids without a check."""
    if len(nodes) and (nodes.min() < 0 or nodes.max() >= n):
        raise ValueError(f"{what} outside [0, {n}): [{nodes.min()}, {nodes.max()}]")


def random_walk_native(
    indptr: np.ndarray, indices: np.ndarray, starts: np.ndarray,
    walk_length: int, seed: int,
) -> np.ndarray:
    """Uniform random walks over CSR adjacency (one std::mt19937_64 stream
    seeded with ``seed``); nodes without out-edges stay put. Returns
    [len(starts), walk_length + 1] node ids."""
    lib = load_native()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    starts = np.ascontiguousarray(starts, np.int64)
    _check_nodes(starts, len(indptr) - 1, "start nodes")
    out = np.empty((len(starts), walk_length + 1), np.int64)
    lib.ampnet_random_walk(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        len(indptr) - 1, _ptr(starts, ctypes.c_int64), len(starts),
        walk_length, seed & (2**64 - 1), _ptr(out, ctypes.c_int64),
    )
    return out


class NativeInducedEdges:
    """Reusable induced-subgraph extractor over a fixed base graph: the
    original ids of the edges with both ends in a sorted node set, in the
    order of the (src, dst)-sorted edge list."""

    def __init__(self, src_indptr: np.ndarray, dst_sorted: np.ndarray,
                 edge_ids: np.ndarray, num_nodes: int):
        self.lib = load_native()
        self.src_indptr = np.ascontiguousarray(src_indptr, np.int64)
        self.dst_sorted = np.ascontiguousarray(dst_sorted, np.int32)
        self.edge_ids = np.ascontiguousarray(edge_ids, np.int64)
        self.n = num_nodes
        self.scratch = np.zeros(num_nodes, np.uint8)
        self.nnz = len(edge_ids)

    def __call__(self, node_set: np.ndarray) -> np.ndarray:
        node_set = np.ascontiguousarray(node_set, np.int64)
        _check_nodes(node_set, self.n, "node ids")
        out = np.empty(self.nnz, np.int64)
        cnt = self.lib.ampnet_induced_edges(
            _ptr(node_set, ctypes.c_int64), len(node_set),
            _ptr(self.scratch, ctypes.c_uint8), self.n,
            _ptr(self.src_indptr, ctypes.c_int64),
            _ptr(self.dst_sorted, ctypes.c_int32),
            _ptr(self.edge_ids, ctypes.c_int64),
            _ptr(out, ctypes.c_int64), self.nnz,
        )
        return out[:cnt]


def norm_prepass_native(
    indptr: np.ndarray, indices: np.ndarray,
    src_indptr: np.ndarray, dst_sorted: np.ndarray, edge_ids: np.ndarray,
    num_nodes: int, batch_size: int, walk_length: int, coverage: int,
    num_steps: int, seed: int, num_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """GraphSAINT's normalization pre-pass: (node counts, edge counts,
    number of subgraphs) over subgraphs sampled until num_nodes * coverage
    nodes were seen, in chunks of 4 samples a thread (``num_threads`` <= 0:
    DEFAULT_THREADS), each sample on a random stream of its own, so that the
    counts are a function of the graph, the seed and the thread count."""
    lib = load_native()
    if num_threads <= 0:
        num_threads = DEFAULT_THREADS
    nnz = len(edge_ids)
    node_count = np.zeros(num_nodes, np.float64)
    edge_count = np.zeros(nnz, np.float64)
    num_samples = lib.ampnet_norm_prepass(
        _ptr(np.ascontiguousarray(indptr, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(indices, np.int32), ctypes.c_int32),
        num_nodes,
        _ptr(np.ascontiguousarray(src_indptr, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(dst_sorted, np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(edge_ids, np.int64), ctypes.c_int64),
        nnz, batch_size, walk_length, coverage, num_steps,
        seed & (2**64 - 1), num_threads,
        _ptr(node_count, ctypes.c_double), _ptr(edge_count, ctypes.c_double),
    )
    return node_count, edge_count, int(num_samples)
