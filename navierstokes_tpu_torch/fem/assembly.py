"""Global FEM assembly straight into the scalar-DIA layout.

The block sparsity pattern is built once on the host.  Each element's 256
scalar entries map to fixed flat positions `k * ndof + row` of the (K, ndof)
DIA layout (`dia_elem_map`), so assembling an operator is one batched
element computation per chunk of elements and one flat scatter-add.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.fem import elements as el
from navierstokes_tpu_torch.fem.dirichlet import DirichletBC, build_dirichlet
from navierstokes_tpu_torch.mesh.core import Mesh
from navierstokes_tpu_torch.ops.scatter import index_add_fixed_order
from navierstokes_tpu_torch.sparse.bcsr import bcsr_pattern_from_coo
from navierstokes_tpu_torch.sparse.dia import DIAPattern, build_dia_pattern

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
    coords = torch.as_tensor(mesh.coords, dtype=dtype, device=device)
    tets = torch.as_tensor(mesh.tets, dtype=torch.int64, device=device)
    vol, grad, h = el.element_geometry(coords[tets])

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
    return Discretization(
        mesh=mesh,
        tets=tets,
        vol=vol,
        grad=grad,
        h=h,
        dia_pattern=dia_pattern,
        dia_elem_map=torch.as_tensor(dia_elem_map.reshape(-1),
                                     dtype=torch.int64, device=device),
        bc=build_dirichlet(mesh, dtype=dtype, device=device),
    )


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
