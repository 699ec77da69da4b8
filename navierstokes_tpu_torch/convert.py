"""Carry the JAX package's state across to this package, as numpy arrays.

Used to feed both packages identical inputs.  Nothing here imports JAX:
every function takes duck-typed objects (a JAX `Mesh`, a frozen config
dataclass, arrays with `__array__`) and returns numpy or port objects.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.config import NewtonConfig, NSConfig, SolverConfig
from navierstokes_tpu_torch.mesh.core import Mesh
from navierstokes_tpu_torch.solvers.coarse import CoarseSpace
from navierstokes_tpu_torch.sparse.bcsr import BCSR4
from navierstokes_tpu_torch.sparse.bell import BlockELL
from navierstokes_tpu_torch.sparse.dia import ScalarDIA


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


def _tensor(a, device) -> torch.Tensor:
    """An array (numpy, or JAX through `__array__`) -> a tensor.  A bfloat16
    array (numpy's `ml_dtypes` kind, which `torch.as_tensor` refuses)
    crosses as its 16-bit pattern."""
    arr = np.array(a)
    if arr.dtype.name == "bfloat16":
        return torch.as_tensor(arr.view(np.int16),
                               device=device).view(torch.bfloat16)
    return torch.as_tensor(arr, device=device)


def scalar_dia_from_jax(dia, device="cpu") -> ScalarDIA:
    """A JAX-package `ScalarDIA` (offsets, data, nnz) -> the port's."""
    return ScalarDIA(offsets=tuple(int(d) for d in dia.offsets),
                     data=_tensor(dia.data, device), nnz=int(dia.nnz))


def bcsr_from_jax(m, device="cpu") -> BCSR4:
    """A JAX-package `BCSR4` (host pattern, device values) -> the port's."""
    return BCSR4(indptr=np.asarray(m.indptr), indices=np.asarray(m.indices),
                 values=_tensor(m.values, device))


def bell_from_jax(ell, device="cpu") -> BlockELL:
    """A JAX-package `BlockELL` (host pattern, device values) -> the
    port's."""
    return BlockELL(indices=np.asarray(ell.indices),
                    values=_tensor(ell.values, device), nnzb=int(ell.nnzb))


def _coarse_space(cs) -> CoarseSpace:
    return CoarseSpace(n_agg=int(cs.n_agg), agg_size=int(cs.agg_size),
                       nb=int(cs.nb))


def _schur_prep(prep, device):
    """The JAX ("sch", noffs, p4, arrays, (cs, SchurStatic), nb, nbp)
    tuple -> `SchurPrep`: tiled plane stacks through `planes_from_tiled`,
    the rest as it is."""
    from navierstokes_tpu_torch.model.navier_stokes import SchurPrep

    _, noffs, p4, arrays, (cs, ss), nb, nbp = prep
    p_f, p_b, p_g, d9, s_tiled, s_dinv, vc_inv, sc_inv = arrays

    def planes(tiled):
        return None if tiled is None else _tensor(planes_from_tiled(tiled),
                                                  device)

    out = SchurPrep(
        tuple(int(d) for d in noffs), planes(p4), planes(p_f), planes(p_b),
        planes(p_g), _tensor(d9, device), tuple(int(d) for d in ss.s_offsets),
        planes(s_tiled), _tensor(s_dinv, device), _tensor(vc_inv, device),
        _tensor(sc_inv, device), _coarse_space(cs),
        None if ss.cheby_v is None else tuple(ss.cheby_v),
        None if ss.cheby_s is None else tuple(ss.cheby_s), ss.shape,
        int(nb), int(nbp))
    if out.p4.shape[-1] != out.nbp:
        raise ValueError(f"tiled planes hold {out.p4.shape[-1]} rows, "
                         f"nbp={out.nbp}")
    return out


def _coarse(c_arrays, c_static, device):
    """A JAX (c_arrays, c_static) coarse level -> the port's."""
    from navierstokes_tpu_torch.model.navier_stokes import (
        DenseCoarse,
        DenseLinearCoarse,
        MultilevelCoarse,
    )

    if c_static[0] == "dense":
        return DenseCoarse(_tensor(c_arrays[0], device))
    if c_static[0] == "dense_lin":
        return DenseLinearCoarse(_tensor(c_arrays[0], device),
                                 _tensor(c_arrays[1], device))
    if c_static[0] == "ml":
        ac1, invd1, ac2_inv = (_tensor(a, device) for a in c_arrays)
        return MultilevelCoarse(tuple(c_static[2]), ac1, invd1,
                                _coarse_space(c_static[3]), ac2_inv)
    raise ValueError(f"unknown coarse level {c_static[0]!r}")


def prep_from_jax(prep, device="cpu"):
    """A JAX-package prepared tuple -> the port's prep.

    'bj': ("bj", s_offsets, s_data, invd_offsets, invd_data);
    'tl': ("tl", offsets, data, invd_offsets, invd_data, c_arrays,
    c_static[, cheby]); 'tlp': ("tlp", noffs, p4, d16, c_arrays, c_static,
    nb, nbp[, cheby]); c_static is ("dense", cs), ("dense_lin", cs) (with
    c_arrays (ac_inv, w)) or ("ml", cs, c_off, cs2), and a smoothed-
    aggregation prep is a 'dense' one whose omega the config holds;
    'sch': ("sch", noffs, p4, arrays, (cs, SchurStatic), nb, nbp); 'defl':
    ("defl", prep, U, Q) around any of these.  Tile-major plane stacks
    are carried into the plane-major layout.  bfloat16 operator data ('tl'
    and 'bj' with matvec_dtype) stays bf16.  Pretiled scalar-DIA (3-D)
    data is not taken: prepare it off the TPU."""
    from navierstokes_tpu_torch.model.navier_stokes import (
        BlockJacobiPrep,
        DeflatedPrep,
        PlanePrep,
        ScalarTwoLevelPrep,
    )

    kind = prep[0]
    if kind == "defl":
        return DeflatedPrep(prep_from_jax(prep[1], device),
                            _tensor(prep[2], device), _tensor(prep[3], device))
    if kind == "sch":
        return _schur_prep(prep, device)
    if kind == "tlp":
        _, noffs, p4, d16, c_arrays, c_static, nb, nbp = prep[:8]
        out = PlanePrep(tuple(int(d) for d in noffs),
                        _tensor(planes_from_tiled(p4), device),
                        _tensor(d16, device),
                        _coarse(c_arrays, c_static, device),
                        _coarse_space(c_static[1]), int(nb), int(nbp),
                        cheby=tuple(prep[8]) if len(prep) > 8 else None)
        if out.p4.shape[-1] != out.nbp:
            raise ValueError(f"tiled planes hold {out.p4.shape[-1]} rows, "
                             f"nbp={out.nbp}")
        return out
    if np.ndim(prep[2]) != 2:
        raise ValueError("prep_from_jax takes row-major (K, n) DIA data")
    if kind == "bj":
        return BlockJacobiPrep(tuple(prep[1]), _tensor(prep[2], device),
                               _tensor(prep[4], device))
    if kind != "tl":
        raise ValueError(f"prep_from_jax takes 'bj', 'tl', 'tlp', 'sch' or "
                         f"'defl', got {kind!r}")
    c_arrays, c_static = prep[5], prep[6]
    return ScalarTwoLevelPrep(
        tuple(prep[1]), _tensor(prep[2], device), _tensor(prep[4], device),
        _coarse(c_arrays, c_static, device), _coarse_space(c_static[1]),
        cheby=tuple(prep[7]) if len(prep) > 7 else None)


def planes_from_tiled(tiled) -> np.ndarray:
    """A JAX tile-major plane operator (grid, n_out, NT, tile) -> the port's
    plane-major layout (n_out, NT, grid * tile)."""
    t = np.asarray(tiled)
    grid, n_out, nt, tile = t.shape
    return t.transpose(1, 2, 0, 3).reshape(n_out, nt, grid * tile).copy()
