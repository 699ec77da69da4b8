"""Global FEM assembly: element contributions -> the scalar-DIA or the
block-CSR operator, and the element-wise residual.

The block sparsity pattern is built once on the host.  Each element's 256
scalar entries map to fixed flat positions `k * ndof + row` of the (K, ndof)
DIA layout (`dia_elem_map`), so assembling an operator is one batched
element computation per chunk of elements and one flat scatter-add.  The
block-CSR route (`assemble_bcsr_values`, `assemble_operator`) adds each
element's 16 node-pair blocks into their BCSR slots (`slot_of_pair`): the
layout of the host oracles (`solvers/precond.py`) and, through
`ell_indices` / `slot_of_bcsr`, of the block-ELL form (`sparse/bell.py`),
both built at first use.  The residual is one
per-element contraction and two scatter-adds (`assemble_residual`).  Every
scatter-add runs in a fixed order, so a run on the card repeats bit for
bit.  `save_discretization` and `load_discretization` keep the host half
of the build in a cache directory (the bench tools' `--disc-cache`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from navierstokes_tpu_torch import native
from navierstokes_tpu_torch.fem import elements as el
from navierstokes_tpu_torch.fem.dirichlet import DirichletBC, build_dirichlet
from navierstokes_tpu_torch.mesh.core import Mesh
from navierstokes_tpu_torch.ops.scatter import index_add_fixed_order
from navierstokes_tpu_torch.sparse.bcsr import BCSR4, bcsr_pattern_from_coo
from navierstokes_tpu_torch.sparse.bell import bell_pattern_from_bcsr
from navierstokes_tpu_torch.sparse.dia import (
    DIAPattern,
    scaled_plan,
    build_dia_pattern,
)

STOKES_TERMS = frozenset({"diffusion"})
LINEAR_TERMS = frozenset({"mass_dt", "diffusion"})
NONLINEAR_TERMS = frozenset({"convection", "convection_jacobian"})
FULL_JACOBIAN_TERMS = LINEAR_TERMS | NONLINEAR_TERMS


@dataclasses.dataclass
class Discretization:
    """The per-mesh data the flagship path reads, on one device."""

    mesh: Mesh
    tets: torch.Tensor           # (ne, 4) int64
    vol: torch.Tensor            # (ne,)
    grad: torch.Tensor           # (ne, 4, 3)
    h: torch.Tensor              # (ne,)
    dia_pattern: DIAPattern
    dia_elem_map: torch.Tensor   # (ne*256,) int64: element entry -> flat DIA
    bc: DirichletBC
    # The block-CSR pattern on the host: (indptr, indices, slot_of_pair),
    # kept from the build, or built from the mesh at first use after a
    # cache load (the cache holds the DIA half only).
    bcsr_pattern: Optional[tuple] = dataclasses.field(default=None,
                                                      repr=False)
    # The block-ELL pattern (ell_indices, slot_of_bcsr), built from the
    # block-CSR pattern at first use (or loaded from a cache that holds
    # it), with `ell_slots_asked` slots per row (None: the row degree).
    ell_pattern: Optional[tuple] = dataclasses.field(default=None,
                                                     repr=False)
    ell_slots_asked: Optional[int] = None

    @property
    def nv(self) -> int:
        return self.mesh.nv

    @property
    def ne(self) -> int:
        return self.mesh.ne

    @property
    def ndof(self) -> int:
        return 4 * self.mesh.nv

    def _bcsr(self) -> tuple:
        if self.bcsr_pattern is None:
            self.bcsr_pattern = block_pattern(self.mesh)
        return self.bcsr_pattern

    @property
    def indptr(self) -> np.ndarray:
        """(nb + 1,) block-row pointers."""
        return self._bcsr()[0]

    @property
    def indices(self) -> np.ndarray:
        """(nnzb,) block-column indices, sorted per row."""
        return self._bcsr()[1]

    @property
    def slot_of_pair(self) -> np.ndarray:
        """(ne * 16,) element node pair (i, j) -> block slot."""
        return self._bcsr()[2]

    @property
    def nnzb(self) -> int:
        return len(self.indices)

    @property
    def row_ids(self) -> np.ndarray:
        """(nnzb,) block row of each slot."""
        return np.repeat(np.arange(self.nv, dtype=np.int32),
                         np.diff(self.indptr))

    @property
    def diag_slots(self) -> np.ndarray:
        """(nb,) slot of each diagonal block."""
        return np.flatnonzero(self.indices == self.row_ids).astype(np.int32)

    def _ell(self) -> tuple:
        if self.ell_pattern is None:
            self.ell_pattern = bell_pattern_from_bcsr(
                self.indptr, self.indices, self.ell_slots_asked)
        return self.ell_pattern

    @property
    def ell_indices(self) -> np.ndarray:
        """(nb, S) int32 block-ELL pattern (`sparse/bell.py`)."""
        return self._ell()[0]

    @property
    def slot_of_bcsr(self) -> np.ndarray:
        """(nnzb,) block slot -> flat block-ELL slot."""
        return self._ell()[1]

    @property
    def ell_slots(self) -> int:
        """S, the block-ELL slots per row."""
        if self.ell_pattern is not None:
            return self.ell_pattern[0].shape[1]
        return self.ell_slots_asked or int(np.diff(self.indptr).max())


def build_discretization(mesh: Mesh, dtype: torch.dtype,
                         device: torch.device,
                         ell_slots: Optional[int] = None) -> Discretization:
    """Element geometry in `dtype` on `device`; pattern and maps on the host.

    The geometry is computed in the run's dtype (float32 on the card), as
    the JAX package does: no silent promotion.  `ell_slots` sets the
    block-ELL slots per row (built at first use); one below the maximum
    row degree raises the JAX package's ValueError here."""
    bcsr, dia_pattern, dia_elem_map = _host_pattern(mesh)
    disc = _on_device(mesh, dia_pattern, dia_elem_map, dtype, device)
    disc.bcsr_pattern = bcsr
    if ell_slots is not None:
        degree = int(np.diff(bcsr[0]).max())
        if ell_slots < degree:
            raise ValueError(f"slots={ell_slots} < max row degree {degree}")
        disc.ell_slots_asked = ell_slots
    return disc


def block_pattern(mesh: Mesh) -> tuple:
    """(indptr, indices, slot_of_pair): all (i, j) node pairs per element,
    from the native host library where it is built (`native/`), else from
    numpy; the two are equal."""
    built = native.build_pattern_native(mesh.nv, mesh.tets)
    return built if built is not None else block_pattern_numpy(mesh)


def block_pattern_numpy(mesh: Mesh) -> tuple:
    """`block_pattern` in numpy."""
    t = mesh.tets
    rows = np.repeat(t, 4, axis=1).ravel()
    cols = np.tile(t, (1, 4)).ravel()
    return bcsr_pattern_from_coo(rows, cols, mesh.nv)


def _host_pattern(mesh: Mesh) -> tuple:
    """The host half of the build: the block pattern, the scalar-DIA
    pattern and the element entry -> flat DIA slot map (ne*256,) int64."""
    bcsr = block_pattern(mesh)
    indptr, indices, slot_of_pair = bcsr
    row_ids = np.repeat(np.arange(mesh.nv, dtype=np.int32), np.diff(indptr))
    if np.count_nonzero(indices == row_ids) != mesh.nv:
        raise ValueError("missing diagonal blocks in FEM pattern")

    dia_pattern = build_dia_pattern(indptr, indices)
    # element scalar entry (e, i, j, a, b) -> flat DIA slot, composing the
    # pair -> block-slot and block-entry -> DIA maps
    dia_elem_map = dia_pattern.flat_map.reshape(-1, 16)[slot_of_pair]
    return bcsr, dia_pattern, dia_elem_map.reshape(-1)


def _on_device(mesh: Mesh, dia_pattern: DIAPattern, dia_elem_map,
               dtype: torch.dtype, device: torch.device) -> Discretization:
    """The device half: element geometry and the BC table in `dtype`, the
    element map as a tensor."""
    coords = torch.as_tensor(mesh.coords, dtype=dtype, device=device)
    tets = torch.as_tensor(mesh.tets, dtype=torch.int64, device=device)
    vol, grad, h = el.element_geometry(coords[tets])
    return Discretization(
        mesh=mesh,
        tets=tets,
        vol=vol,
        grad=grad,
        h=h,
        dia_pattern=dia_pattern,
        dia_elem_map=torch.as_tensor(dia_elem_map, dtype=torch.int64,
                                     device=device),
        bc=build_dirichlet(mesh, dtype=dtype, device=device),
    )


# The discretization cache: the port's own format, a directory of .npy
# files read with allow_pickle=False.  It holds the host half of the build
# (the mesh, the DIA pattern and the element map: the setup cost at scale);
# the element geometry and the BC table are computed again on load, in the
# dtype and on the device asked for, so a solve from the cache equals one
# from a fresh build bit for bit.  Where the block-ELL pattern was built
# or its slots asked for, it is kept too (`_ELL_ARRAYS`); a cache without
# it loads, and builds it at first use.  The JAX package's cache pickles
# its own Mesh and DiaPattern classes and is not read.
CACHE_FORMAT = 1
_ELL_ARRAYS = ("ell_indices", "slot_of_bcsr")


def is_discretization_cache(cache_dir: str) -> bool:
    """True where `save_discretization` finished writing `cache_dir`."""
    return os.path.exists(os.path.join(cache_dir, "format.npy"))


def save_discretization(disc: Discretization, out_dir: str) -> None:
    """Write the host half of `disc` to the directory `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    pat = disc.dia_pattern
    emap = disc.dia_elem_map
    if emap is None:
        raise ValueError("the element map was released "
                         "(release_assembly_buffers); save before that")
    arrays = {
        "coords": disc.mesh.coords, "tets": disc.mesh.tets,
        "node_tags": disc.mesh.node_tags,
        "dia_offsets": np.asarray(pat.offsets, dtype=np.int64),
        "dia_flat_map": pat.flat_map,
        # int32 where the flat DIA layout fits (K * ndof < 2^31: every
        # matrix of the scaling series), half the bytes on disk
        "dia_elem_map": emap.cpu().numpy().astype(
            np.int32 if pat.K * pat.ndof < 2**31 else np.int64),
    }
    if disc.ell_pattern is not None or disc.ell_slots_asked is not None:
        arrays.update(zip(_ELL_ARRAYS, disc._ell()))
    for name, arr in arrays.items():
        np.save(os.path.join(out_dir, f"{name}.npy"), arr)
    # written last: a cache cut short is not taken for a whole one
    np.save(os.path.join(out_dir, "format.npy"),
            np.asarray([CACHE_FORMAT, pat.ndof, pat.nnz], dtype=np.int64))


def cached_discretization(cache_dir: str, make_mesh, dtype: torch.dtype,
                          device: torch.device) -> tuple:
    """(disc, loaded): the discretization from `cache_dir` where it holds
    one, else built from `make_mesh()` and saved there.  The bench tools'
    `--disc-cache`."""
    if is_discretization_cache(cache_dir) or os.path.exists(
            os.path.join(cache_dir, "mesh.pkl")):
        return load_discretization(cache_dir, dtype, device), True
    disc = build_discretization(make_mesh(), dtype, device)
    save_discretization(disc, cache_dir)
    return disc, False


def load_discretization(cache_dir: str, dtype: torch.dtype,
                        device: torch.device) -> Discretization:
    """The Discretization saved in `cache_dir` by `save_discretization`,
    with its geometry and BC table built in `dtype` on `device`."""
    if not is_discretization_cache(cache_dir):
        jax_cache = os.path.exists(os.path.join(cache_dir, "mesh.pkl"))
        raise ValueError(
            f"{cache_dir} holds no discretization cache of this package"
            + (" (it holds the JAX package's pickled cache, which is not "
               "read)" if jax_cache else ""))

    def load(name):
        return np.load(os.path.join(cache_dir, f"{name}.npy"),
                       allow_pickle=False)

    fmt, ndof, nnz = (int(v) for v in load("format"))
    if fmt != CACHE_FORMAT:
        raise ValueError(f"{cache_dir}: cache format {fmt}, this package "
                         f"reads {CACHE_FORMAT}")
    mesh = Mesh(coords=load("coords"), tets=load("tets"),
                node_tags=load("node_tags"))
    offsets = [int(d) for d in load("dia_offsets")]
    scaled_offsets, scaled_terms = scaled_plan(offsets)
    pattern = DIAPattern(offsets=tuple(offsets), ndof=ndof,
                         flat_map=load("dia_flat_map"), nnz=nnz,
                         scaled_offsets=scaled_offsets,
                         scaled_terms=scaled_terms)
    if ndof != mesh.ndof:
        raise ValueError(f"{cache_dir}: pattern of {ndof} rows for a mesh "
                         f"of {mesh.ndof}")
    disc = _on_device(mesh, pattern, load("dia_elem_map"), dtype, device)
    if os.path.exists(os.path.join(cache_dir, "ell_indices.npy")):
        disc.ell_pattern = tuple(load(name) for name in _ELL_ARRAYS)
    return disc


def local_fields(tets: torch.Tensor, u: torch.Tensor) -> tuple:
    """Per-element nodal fields of the global DoF vector u (4 nv,):
    UL (ne, 3, 4) component-major velocity, PL (ne, 4) pressure."""
    ue = u.reshape(-1, 4)[tets]                  # (ne, 4 nodes, 4 dof)
    return ue[:, :, :3].transpose(1, 2), ue[:, :, 3]


def assemble_residual(tets: torch.Tensor, vol: torch.Tensor,
                      grad: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
                      u_old: torch.Tensor, dt: float, reynolds: float,
                      delta: float, *, ndof: int) -> torch.Tensor:
    """The residual F(u) (ndof,): one element-wise contraction
    (`elements.element_residual`), then the velocity and the pressure
    scatter-adds, each in a fixed order."""
    UL, PL = local_fields(tets, u)
    UL_old, _ = local_fields(tets, u_old)
    F_v, F_p = el.element_residual(grad, vol, h, UL, UL_old, PL, dt,
                                   reynolds, delta)
    comp = torch.arange(3, device=tets.device)
    vdofs = (4 * tets)[:, :, None] + comp                    # (ne, 4, 3)
    F = torch.zeros(ndof, dtype=u.dtype, device=u.device)
    index_add_fixed_order(F, vdofs.reshape(-1), F_v.reshape(-1))
    index_add_fixed_order(F, (4 * tets + 3).reshape(-1), F_p.reshape(-1))
    return F


def _chunks(ne: int, chunk: int):
    for s in range(0, ne, chunk):
        yield slice(s, min(s + chunk, ne))


def assemble_dia_values(vol: torch.Tensor, grad: torch.Tensor,
                        h: torch.Tensor, dt: float, reynolds: float,
                        delta: float, dia_elem_map: torch.Tensor, *,
                        terms: frozenset, K: int, ndof: int,
                        chunk: int = 16384,
                        UL: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Assemble the selected element terms into the (K, ndof) DIA layout
    (`UL` (ne, 3, 4), from `local_fields`, for the convection terms).

    Elements go in chunks of `chunk` (bounded intermediates at any mesh
    size); each chunk's (chunk, 256) blocks are added into the flat layout
    with one scatter-add in a fixed order, so an operator assembled on the
    card is the same in every run."""
    ne = vol.shape[0]
    flat = torch.zeros(K * ndof, dtype=vol.dtype, device=vol.device)
    emap = dia_elem_map.reshape(ne, 256)
    for e in _chunks(ne, chunk):
        blocks = el.element_node_blocks(
            grad[e], vol[e], h[e], dt, reynolds, delta, terms=terms,
            UL=None if UL is None else UL[e])
        index_add_fixed_order(flat, emap[e].reshape(-1), blocks.reshape(-1))
    return flat.reshape(K, ndof)


def assemble_bcsr_values(vol: torch.Tensor, grad: torch.Tensor,
                         h: torch.Tensor, UL: Optional[torch.Tensor],
                         dt: float, reynolds: float, delta: float,
                         slot_of_pair: np.ndarray, *, terms: frozenset,
                         nnzb: int, chunk: int = 16384) -> torch.Tensor:
    """Block-CSR values (nnzb, 4, 4) of the selected element terms: each
    element's 16 node-pair blocks added into their slots in a fixed
    order."""
    ne = vol.shape[0]
    out = torch.zeros(nnzb * 16, dtype=vol.dtype, device=vol.device)
    slots = torch.as_tensor(slot_of_pair, dtype=torch.int64,
                            device=vol.device).reshape(ne, 16)
    entry = torch.arange(16, device=vol.device)
    for e in _chunks(ne, chunk):
        blocks = el.element_node_blocks(
            grad[e], vol[e], h[e], dt, reynolds, delta, terms=terms,
            UL=None if UL is None else UL[e])
        idx = (16 * slots[e])[:, :, None] + entry          # (E, 16, 16)
        index_add_fixed_order(out, idx.reshape(-1), blocks.reshape(-1))
    return out.reshape(nnzb, 4, 4)


def assemble_operator(disc: Discretization, u: torch.Tensor, dt: float,
                      reynolds: float, delta: float,
                      terms: frozenset) -> BCSR4:
    """The operator of `terms` at the state u as a `BCSR4` on the
    discretization's block pattern."""
    UL, _ = local_fields(disc.tets, u)
    values = assemble_bcsr_values(disc.vol, disc.grad, disc.h, UL, dt,
                                  reynolds, delta, disc.slot_of_pair,
                                  terms=terms, nnzb=disc.nnzb)
    return BCSR4(indptr=disc.indptr, indices=disc.indices, values=values)
