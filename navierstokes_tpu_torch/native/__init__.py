"""ctypes binding of the native host library (`nstpu_native.cpp`): the Gmsh
2.2 parser, the block-pattern build and reverse Cuthill-McKee.

The JAX package's `native/`, with the port's own copy of the source.  At
first use the source is compiled by g++ into `navierstokes_tpu_torch/_build/`
(listed in `.gitignore`).  The library's file name carries a hash of the
source, the flags and the compiler's version, and the build writes a
temporary file that `os.replace` puts in place, so processes that build at
once (test workers) never load a half-written library.  Where no g++ is
found, `available()` is False and each caller runs its numpy or Python
version, the JAX package's semantics for a host without a compiler; the
outputs are equal (`tests/test_torch_native.py`).  A compile that fails
raises.  Host code only: the CUDA kernels are built by `ops/cuda_lib.py`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "nstpu_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")

_state: dict = {}


def _cxx() -> Optional[str]:
    return shutil.which("g++")


def library_path(cxx: str) -> Path:
    """The library's path for this source, these flags and this compiler."""
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(version.encode())
    return BUILD_DIR / f"libnstpu_native_{h.hexdigest()[:16]}.so"


def build(cxx: str) -> Path:
    """Compile the library unless one for this source, flags and compiler
    exists; returns its path."""
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib) -> None:
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.nstpu_gmsh_parse.restype = vp
    lib.nstpu_gmsh_parse.argtypes = [ctypes.c_char_p]
    lib.nstpu_gmsh_error.restype = ctypes.c_char_p
    lib.nstpu_gmsh_error.argtypes = [vp]
    lib.nstpu_gmsh_nv.restype = i64
    lib.nstpu_gmsh_nv.argtypes = [vp]
    lib.nstpu_gmsh_ne.restype = i64
    lib.nstpu_gmsh_ne.argtypes = [vp]
    lib.nstpu_gmsh_fill.restype = None
    lib.nstpu_gmsh_fill.argtypes = [vp, f64, i32, i32]
    lib.nstpu_gmsh_free.restype = None
    lib.nstpu_gmsh_free.argtypes = [vp]
    lib.nstpu_pattern_build.restype = vp
    lib.nstpu_pattern_build.argtypes = [i64, i64, i32]
    lib.nstpu_pattern_nnzb.restype = i64
    lib.nstpu_pattern_nnzb.argtypes = [vp]
    lib.nstpu_pattern_fill.restype = None
    lib.nstpu_pattern_fill.argtypes = [vp, i32, i32, i32]
    lib.nstpu_pattern_free.restype = None
    lib.nstpu_pattern_free.argtypes = [vp]
    lib.nstpu_rcm.restype = None
    lib.nstpu_rcm.argtypes = [i64, i32, i32, i32]


def _load():
    """The loaded library, built on first call; None where no g++ is
    found."""
    if "lib" not in _state:
        cxx = _cxx()
        lib = None
        if cxx is not None:
            lib = ctypes.CDLL(str(build(cxx)))
            _declare(lib)
        _state["lib"] = lib
    return _state["lib"]


def available() -> bool:
    """True where the native library is built and loaded."""
    return _load() is not None


def backend() -> str:
    """Which pattern build and mesh reader run: 'native' or 'numpy'."""
    return "native" if available() else "numpy"


def parse_gmsh_native(path: str):
    """(coords, tets, tags) of the Gmsh 2.2 file `path`, or None without
    the library; a file it cannot read raises a ValueError."""
    lib = _load()
    if lib is None:
        return None
    h = lib.nstpu_gmsh_parse(os.fsencode(path))
    try:
        err = lib.nstpu_gmsh_error(h)
        if err:
            raise ValueError(err.decode())
        nv = lib.nstpu_gmsh_nv(h)
        ne = lib.nstpu_gmsh_ne(h)
        coords = np.empty((nv, 3), np.float64)
        tets = np.empty((ne, 4), np.int32)
        tags = np.empty(nv, np.int32)
        lib.nstpu_gmsh_fill(h, coords, tets.reshape(-1), tags)
        return coords, tets, tags
    finally:
        lib.nstpu_gmsh_free(h)


def build_pattern_native(nv: int, tets: np.ndarray):
    """(indptr, indices, slot_of_pair) int32 of the block pattern of `tets`
    (nv nodes), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    tets = np.ascontiguousarray(tets, np.int32)
    if tets.ndim != 2 or tets.shape[1] != 4:
        raise ValueError(f"tets of shape {tets.shape}, expected (ne, 4)")
    if tets.size and (tets.min() < 0 or tets.max() >= nv):
        raise ValueError(f"tets index outside [0, {nv})")
    ne = tets.shape[0]
    h = lib.nstpu_pattern_build(nv, ne, tets.reshape(-1))
    try:
        nnzb = lib.nstpu_pattern_nnzb(h)
        indptr = np.empty(nv + 1, np.int32)
        indices = np.empty(nnzb, np.int32)
        slot = np.empty(ne * 16, np.int32)
        lib.nstpu_pattern_fill(h, indptr, indices, slot)
        return indptr, indices, slot
    finally:
        lib.nstpu_pattern_free(h)


def rcm_native(nv: int, indptr: np.ndarray, indices: np.ndarray):
    """The reverse Cuthill-McKee permutation (perm[new] = old, int32) of
    the block pattern (indptr, indices), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    if len(indptr) != nv + 1 or (len(indices) and (
            indices.min() < 0 or indices.max() >= nv)):
        raise ValueError("pattern does not match nv")
    perm = np.empty(nv, np.int32)
    lib.nstpu_rcm(nv, indptr, indices, perm)
    return perm
