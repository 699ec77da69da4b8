"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  At first CUDA use it is
compiled by `nvcc` for Hopper (`sm_90a`) into `navierstokes_tpu_torch/_build/`
(listed in `.gitignore`) and loaded with `ctypes`.  The library file name
carries a hash of the source and the flags, so an edited source rebuilds.
Nothing here runs at import time: a machine without `nvcc` imports the
package, and only a CUDA launch needs the compiler.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


@dataclasses.dataclass
class BuildInfo:
    """What one build did: library path, seconds spent, compiler output."""

    path: Path
    seconds: float
    log: str
    cached: bool


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: CUDA kernels are built at first use "
                       "and need the CUDA toolkit")


def build(name: str) -> BuildInfo:
    """Compile `csrc/<name>.cu` unless a library for this exact source and
    these flags exists already."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "", cached=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return BuildInfo(out, seconds, proc.stdout + proc.stderr, cached=False)


def load(name: str) -> tuple:
    """(ctypes.CDLL, BuildInfo) for `csrc/<name>.cu`, built on first call."""
    if name not in _loaded:
        info = build(name)
        _loaded[name] = (ctypes.CDLL(str(info.path)), info)
    return _loaded[name]
