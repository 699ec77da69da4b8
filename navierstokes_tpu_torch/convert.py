"""Carry the JAX package's state across to this package, as numpy arrays.

Used to feed both packages identical inputs.  Nothing here imports JAX:
every function takes duck-typed objects (a JAX `Mesh`, a frozen config
dataclass, arrays with `__array__`) and returns numpy or port objects.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from navierstokes_tpu_torch.config import NewtonConfig, NSConfig, SolverConfig
from navierstokes_tpu_torch.mesh.core import Mesh


def mesh_from_jax(mesh) -> Mesh:
    """A JAX-package `Mesh` -> the port's `Mesh` (coords, tets, node_tags)."""
    return Mesh(coords=np.asarray(mesh.coords), tets=np.asarray(mesh.tets),
                node_tags=np.asarray(mesh.node_tags))


def config_from_jax(cfg) -> NSConfig:
    """A JAX-package `NSConfig` -> the port's, from `dataclasses.asdict`."""
    d = dataclasses.asdict(cfg)
    return NSConfig(**{
        **d,
        "newton": NewtonConfig(**d["newton"]),
        "krylov": SolverConfig(**d["krylov"]),
        "stokes_krylov": SolverConfig(**d["stokes_krylov"]),
    })


def state_to_numpy(x) -> np.ndarray:
    """A state vector (JAX array, tensor or numpy) -> a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def planes_from_tiled(tiled) -> np.ndarray:
    """A JAX tile-major plane operator (grid, n_out, NT, tile) -> the port's
    plane-major layout (n_out, NT, grid * tile)."""
    t = np.asarray(tiled)
    grid, n_out, nt, tile = t.shape
    return t.transpose(1, 2, 0, 3).reshape(n_out, nt, grid * tile).copy()
