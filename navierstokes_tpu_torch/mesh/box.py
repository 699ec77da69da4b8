"""Synthetic structured tetrahedral channel meshes (host-side numpy).

The same generators as the JAX package: a channel of cross-section
[-1, 1]^2 with an optional ellipsoidal obstacle, each hexahedral cell split
into 6 positively oriented Kuhn tetrahedra, and the 10-matrix scaling series.
"""

from __future__ import annotations

import itertools

import numpy as np

from navierstokes_tpu_torch.mesh.core import Mesh

_AXIS_VEC = {0: (1, 0, 0), 1: (0, 1, 0), 2: (0, 0, 1)}


def _kuhn_tets():
    """The 6 Kuhn tets of the unit cube as corner-bit tuples, positively oriented."""
    tets = []
    for perm in itertools.permutations((0, 1, 2)):
        c = [(0, 0, 0)]
        cur = (0, 0, 0)
        for ax in perm:
            v = _AXIS_VEC[ax]
            cur = (cur[0] + v[0], cur[1] + v[1], cur[2] + v[2])
            c.append(cur)
        parity = sum(1 for i in range(3) for j in range(i + 1, 3)
                     if perm[i] > perm[j])
        if parity % 2 == 1:
            c[2], c[3] = c[3], c[2]
        tets.append(tuple(c))
    return tets


_KUHN = _kuhn_tets()


def box_mesh(nx: int, ny: int, nz: int,
             bounds=((0.0, 1.0), (0.0, 1.0), (0.0, 1.0))):
    """Structured tet mesh of a box: coords (nv, 3) and tets (ne, 4)."""
    (x0, x1), (y0, y1), (z0, z1) = bounds
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    zs = np.linspace(z0, z1, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    ci, cj, ck = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    ci, cj, ck = ci.ravel(), cj.ravel(), ck.ravel()
    tets = np.empty((len(ci) * 6, 4), dtype=np.int32)
    for t, corners in enumerate(_KUHN):
        for v, (di, dj, dk) in enumerate(corners):
            tets[t::6, v] = nid(ci + di, cj + dj, ck + dk)
    return coords, tets


def channel_mesh(nx: int, ny: int, nz: int, length: float = 4.0,
                 obstacle: bool = False, obstacle_center=(1.0, 0.0, 0.0),
                 obstacle_radii=(0.3, 0.4, 0.4)) -> Mesh:
    """Channel [0, length] x [-1, 1] x [-1, 1] with reference-compatible tags
    (x=0 -> 2, x=length -> 3, y=-1/+1 -> 4/5, z=-1/+1 -> 6/7, obstacle -> 1;
    priority 1 > 2 > 4/5 > 6/7 > 3)."""
    coords, tets = box_mesh(
        nx, ny, nz, bounds=((0.0, length), (-1.0, 1.0), (-1.0, 1.0)))
    nv = coords.shape[0]
    tags = np.full(nv, -1, dtype=np.int32)
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    eps = 1e-12

    tags[np.abs(x - length) < eps] = 3
    tags[np.abs(z + 1.0) < eps] = 6
    tags[np.abs(z - 1.0) < eps] = 7
    tags[np.abs(y + 1.0) < eps] = 4
    tags[np.abs(y - 1.0) < eps] = 5
    tags[np.abs(x) < eps] = 2
    if obstacle:
        cx, cy, cz = obstacle_center
        rx, ry, rz = obstacle_radii
        inside = (((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2
                  + ((z - cz) / rz) ** 2) <= 1.0
        tags[inside] = 1

    return Mesh(coords=coords, tets=tets, node_tags=tags)


# Cells (nx, ny, nz) of the scaling series' channel meshes.
SCALING_SERIES_DIMS = {
    1: (6, 2, 2),
    2: (10, 5, 5),
    3: (17, 8, 8),
    4: (20, 10, 10),
    5: (32, 15, 15),
    6: (46, 24, 24),
    7: (57, 30, 30),
    8: (75, 40, 40),
    9: (95, 50, 50),
    10: (126, 67, 67),
}


def scaling_series_mesh(matrix_id: int) -> Mesh:
    """Meshes approximating the reference's 10-matrix scaling series
    (matrix_id is 1-based; matrix 6 is the mmesh-class 117,500-row mesh)."""
    nx, ny, nz = SCALING_SERIES_DIMS[matrix_id]
    return channel_mesh(nx, ny, nz, length=4.0, obstacle=matrix_id >= 3)
