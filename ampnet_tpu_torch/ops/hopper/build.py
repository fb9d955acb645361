"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` source compiles into its own shared library with a
plain C interface, for ``sm_90a`` (Hopper). All sources build at first
use, in parallel (one ``nvcc`` each), into ``_build/`` beside this file,
which ``.gitignore`` lists. A library's file name carries a digest of its
sources and flags, so an edited source is rebuilt and a stale build is
never loaded. ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside each library as ``<name>.log``.

Nothing here runs at import: this module is imported on machines without
``nvcc`` (the CPU tests), where only the plain torch versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Union

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the Hopper kernels "
        "are built from source at first use on a CUDA machine")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every csrc/*.cu not yet built, all nvcc runs at once.
    Returns {source stem: library path}; raises with nvcc's output when a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {src.stem: (src, _lib_path(src)) for src in sorted(CSRC.glob("*.cu"))}
    procs = {}
    for stem, (src, lib) in paths.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        procs[stem] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    failed = []
    for stem, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
        else:
            failed.append(f"{stem}: nvcc exit {rc}\n{lib.with_suffix('.log').read_text()}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {stem: lib for stem, (_, lib) in paths.items()}


_PTXAS_ENTRY = re.compile(
    r"Compiling entry function '([^']*)'.*?(\d+) bytes spill stores, "
    r"(\d+) bytes spill loads.*?Used (\d+) registers", re.S)
_TEMPLATE_INT = re.compile(r"ILi(\d+)E")


def parse_ptxas(log: str) -> Dict[Union[int, str], Dict[str, int]]:
    """Per kernel in an ``-Xptxas -v`` log: registers per thread and spill
    bytes, keyed by the first int argument of a kernel template's
    instantiation, or by the mangled name of a kernel that is no template."""
    out = {}
    for name, st, ld, r in _PTXAS_ENTRY.findall(log):
        t = _TEMPLATE_INT.search(name)
        out[int(t.group(1)) if t else name] = dict(
            regs=int(r), spill_stores=int(st), spill_loads=int(ld))
    return out


def ptxas_report(name: str) -> Dict[Union[int, str], Dict[str, int]]:
    """``parse_ptxas`` of csrc/<name>.cu's build log (builds first if needed)."""
    return parse_ptxas(build_all()[name].with_suffix(".log").read_text())


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<name>.cu (builds all at first use)."""
    with _lock:
        if name not in _libs:
            for stem, path in build_all().items():
                _libs.setdefault(stem, ctypes.CDLL(str(path)))
        lib = _libs[name]
    lib.ampnet_error_string.argtypes = [ctypes.c_int]
    lib.ampnet_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(
            f"{what}: CUDA error {code} ({lib.ampnet_error_string(code).decode()})")
