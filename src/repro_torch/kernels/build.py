"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers: seconds, not minutes), in
``build/<name>-<hash>.so`` beside this file, where ``<hash>`` covers the
sources and the flags, so an edited kernel rebuilds and an unchanged one
loads.  :func:`build_all` starts one ``nvcc`` per source, all at once.
Nothing is built when the module is imported: the CPU tests import it on
a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points, by library
SIGNATURES: Dict[str, Dict[str, list]] = {
    "paged_attention": {
        # dtype, hd, q, pool, tables, ctx, out, ws, B, nq, nk, bs, M,
        # n_split, split_len, scale, stream
        "paged_decode_attention":
            [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
             _P],
        # dtype, hd, q, pool, table, start, out, C, nq, nk, bs, M, scale,
        # stream
        "paged_chunked_prefill_attention":
            [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    },
    "dense_attention": {
        # dtype, hd, q, k, v, ctx, out, ws, B, S, nq, nk, n_split,
        # split_len, scale, stream
        "decode_attention":
            [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
        # dtype, hd, q, k, v, start, out, C, S, nq, nk, scale, stream
        "chunked_prefill_attention":
            [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if Path("/usr/local/cuda/bin/nvcc").exists() else None)
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start the nvcc build of ``csrc/<name>.cu`` unless its library is
    already built; returns (process, tmp_path, target) or None."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(job) -> str:
    proc, tmp, target = job
    out, _ = proc.communicate()
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {target.name}:\n{out}")
    os.replace(tmp, target)          # atomic: a reader never sees half
    return out


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every library not built yet, one nvcc per source, in
    parallel; returns nvcc's report (registers, shared memory, spills per
    kernel) for each library it built."""
    names = names or sorted(SIGNATURES)
    jobs = {n: j for n, j in ((n, _start(n)) for n in names)
            if j is not None}
    reports, errors = {}, []
    for name, job in jobs.items():
        try:
            reports[name] = _finish(job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with the
    argument types of its entry points set."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
