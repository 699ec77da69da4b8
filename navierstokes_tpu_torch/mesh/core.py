"""Core mesh data model (host-side numpy), as in the JAX package.

Structure-of-arrays tetrahedral mesh with one surface tag per node
(`src/solve_newton.c:91-197`):
  1 = obstacle (no-slip, u = 0)
  2 = inlet    (no-slip walls + Poiseuille u_x = (1-y^2)(1-z^2))
  3 = outlet   (free outflow, not a boundary node)
  4, 5 = slip walls, u_y = 0 only
  6, 7 = slip walls, u_z = 0 only
"""

from __future__ import annotations

import dataclasses

import numpy as np

TAG_OBSTACLE = 1
TAG_INLET = 2
TAG_OUTLET = 3
TAG_SLIP_Y = (4, 5)
TAG_SLIP_Z = (6, 7)

# Tags that make a node a boundary node (3 is deliberately absent).
COLLECTED_TAGS = (1, 2, 4, 5, 6, 7)


@dataclasses.dataclass
class Mesh:
    """coords (nv, 3) float64, tets (ne, 4) int32, node_tags (nv,) int32."""

    coords: np.ndarray
    tets: np.ndarray
    node_tags: np.ndarray

    def __post_init__(self):
        self.coords = np.ascontiguousarray(self.coords, dtype=np.float64)
        self.tets = np.ascontiguousarray(self.tets, dtype=np.int32)
        self.node_tags = np.ascontiguousarray(self.node_tags, dtype=np.int32)

    @property
    def nv(self) -> int:
        return self.coords.shape[0]

    @property
    def ne(self) -> int:
        return self.tets.shape[0]

    @property
    def ndof(self) -> int:
        """Total DoF count: 4 per node (u_x, u_y, u_z, p)."""
        return 4 * self.nv

    def node_adjacency(self) -> tuple:
        """Symmetric node-to-node adjacency (self pairs included) as sorted
        (rows, cols) int32 COO: the operator's block pattern, one block per
        pair of nodes sharing a tet."""
        t = self.tets
        ii = np.repeat(t, 4, axis=1).ravel()
        jj = np.tile(t, (1, 4)).ravel()
        keys = np.unique(ii.astype(np.int64) * self.nv + jj)
        return ((keys // self.nv).astype(np.int32),
                (keys % self.nv).astype(np.int32))

    @property
    def boundary_nodes(self) -> np.ndarray:
        """Nodes carrying a collected surface tag (sorted ascending)."""
        return np.flatnonzero(
            np.isin(self.node_tags, COLLECTED_TAGS)).astype(np.int32)
