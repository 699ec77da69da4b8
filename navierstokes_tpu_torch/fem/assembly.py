"""Global FEM assembly straight into the scalar-DIA layout.

The block sparsity pattern is built once on the host.  Each element's 256
scalar entries map to fixed flat positions `k * ndof + row` of the (K, ndof)
DIA layout (`dia_elem_map`), so assembling an operator is one batched
element computation per chunk of elements and one flat scatter-add.
`save_discretization` and `load_discretization` keep the host half of the
build in a cache directory (the bench tools' `--disc-cache`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from navierstokes_tpu_torch.fem import elements as el
from navierstokes_tpu_torch.fem.dirichlet import DirichletBC, build_dirichlet
from navierstokes_tpu_torch.mesh.core import Mesh
from navierstokes_tpu_torch.ops.scatter import index_add_fixed_order
from navierstokes_tpu_torch.sparse.bcsr import bcsr_pattern_from_coo
from navierstokes_tpu_torch.sparse.dia import (
    DIAPattern,
    scaled_plan,
    build_dia_pattern,
)

STOKES_TERMS = frozenset({"diffusion"})
LINEAR_TERMS = frozenset({"mass_dt", "diffusion"})


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

    @property
    def nv(self) -> int:
        return self.mesh.nv

    @property
    def ne(self) -> int:
        return self.mesh.ne

    @property
    def ndof(self) -> int:
        return 4 * self.mesh.nv


def build_discretization(mesh: Mesh, dtype: torch.dtype,
                         device: torch.device) -> Discretization:
    """Element geometry in `dtype` on `device`; pattern and maps on the host.

    The geometry is computed in the run's dtype (float32 on the card), as
    the JAX package does: no silent promotion."""
    dia_pattern, dia_elem_map = _host_pattern(mesh)
    return _on_device(mesh, dia_pattern, dia_elem_map, dtype, device)


def _host_pattern(mesh: Mesh) -> tuple:
    """The host half of the build: the scalar-DIA pattern and the element
    entry -> flat DIA slot map (ne*256,) int64."""
    t = mesh.tets
    rows = np.repeat(t, 4, axis=1).ravel()
    cols = np.tile(t, (1, 4)).ravel()
    indptr, indices, slot_of_pair = bcsr_pattern_from_coo(rows, cols, mesh.nv)
    row_ids = np.repeat(np.arange(mesh.nv, dtype=np.int32), np.diff(indptr))
    if np.count_nonzero(indices == row_ids) != mesh.nv:
        raise ValueError("missing diagonal blocks in FEM pattern")

    dia_pattern = build_dia_pattern(indptr, indices)
    # element scalar entry (e, i, j, a, b) -> flat DIA slot, composing the
    # pair -> block-slot and block-entry -> DIA maps
    dia_elem_map = dia_pattern.flat_map.reshape(-1, 16)[slot_of_pair]
    return dia_pattern, dia_elem_map.reshape(-1)


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
# from a fresh build bit for bit.  The JAX package's cache pickles its own
# Mesh and DiaPattern classes and is not read.
CACHE_FORMAT = 1
_CACHE_ARRAYS = ("coords", "tets", "node_tags", "dia_offsets", "dia_flat_map",
                 "dia_elem_map")


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
    for name in _CACHE_ARRAYS:
        np.save(os.path.join(out_dir, f"{name}.npy"), arrays[name])
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
    return _on_device(mesh, pattern, load("dia_elem_map"), dtype, device)


def assemble_dia_values(vol: torch.Tensor, grad: torch.Tensor,
                        h: torch.Tensor, dt: float, reynolds: float,
                        delta: float, dia_elem_map: torch.Tensor, *,
                        terms: frozenset, K: int, ndof: int,
                        chunk: int = 16384) -> torch.Tensor:
    """Assemble the selected element terms into the (K, ndof) DIA layout.

    Elements go in chunks of `chunk` (bounded intermediates at any mesh
    size); each chunk's (chunk, 256) blocks are added into the flat layout
    with one scatter-add in a fixed order, so an operator assembled on the
    card is the same in every run."""
    ne = vol.shape[0]
    flat = torch.zeros(K * ndof, dtype=vol.dtype, device=vol.device)
    emap = dia_elem_map.reshape(ne, 256)
    for s in range(0, ne, chunk):
        e = slice(s, min(s + chunk, ne))
        blocks = el.element_node_blocks(grad[e], vol[e], h[e], dt, reynolds,
                                        delta, terms=terms)
        index_add_fixed_order(flat, emap[e].reshape(-1), blocks.reshape(-1))
    return flat.reshape(K, ndof)
