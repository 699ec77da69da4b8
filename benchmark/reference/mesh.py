"""Frozen copy of the scaling-series mesh generator (host-side numpy).

A channel [0, length] x [-1, 1] x [-1, 1], each hexahedral cell split into
6 positively oriented Kuhn tetrahedra, with one surface tag per node:
1 obstacle, 2 inlet, 3 outlet, 4/5 the y walls, 6/7 the z walls.  The
benchmark makes its meshes here and hands the arrays to the system under
test; `benchmark/tests` holds that they equal the system's own generator
array for array.
"""

from __future__ import annotations

import itertools

import numpy as np

_AXIS_VEC = {0: (1, 0, 0), 1: (0, 1, 0), 2: (0, 0, 1)}


def _kuhn_tets():
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


def box_mesh(nx: int, ny: int, nz: int, bounds) -> tuple:
    """coords (nv, 3) float64 and tets (ne, 4) int32 of a structured box."""
    (x0, x1), (y0, y1), (z0, z1) = bounds
    X, Y, Z = np.meshgrid(np.linspace(x0, x1, nx + 1),
                          np.linspace(y0, y1, ny + 1),
                          np.linspace(z0, z1, nz + 1), indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    ci, cj, ck = (a.ravel() for a in np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))
    tets = np.empty((len(ci) * 6, 4), dtype=np.int32)
    for t, corners in enumerate(_KUHN):
        for v, (di, dj, dk) in enumerate(corners):
            tets[t::6, v] = nid(ci + di, cj + dj, ck + dk)
    return coords, tets


def channel_mesh(nx: int, ny: int, nz: int, length: float = 4.0,
                 obstacle: bool = False, obstacle_center=(1.0, 0.0, 0.0),
                 obstacle_radii=(0.3, 0.4, 0.4)) -> tuple:
    """(coords, tets, node_tags) of the channel; tag priority
    1 > 2 > 4/5 > 6/7 > 3."""
    coords, tets = box_mesh(nx, ny, nz,
                            ((0.0, length), (-1.0, 1.0), (-1.0, 1.0)))
    tags = np.full(coords.shape[0], -1, dtype=np.int32)
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    eps = 1e-12
    tags[np.abs(x - length) < eps] = 3
    tags[np.abs(z + 1.0) < eps] = 6
    tags[np.abs(z - 1.0) < eps] = 7
    tags[np.abs(y + 1.0) < eps] = 4
    tags[np.abs(y - 1.0) < eps] = 5
    tags[np.abs(x) < eps] = 2
    if obstacle:
        (cx, cy, cz), (rx, ry, rz) = obstacle_center, obstacle_radii
        inside = (((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2
                  + ((z - cz) / rz) ** 2) <= 1.0
        tags[inside] = 1
    return coords, tets, tags


def mesh_from_config(mesh_cfg: dict) -> tuple:
    """The mesh a configuration file's "mesh" entry names."""
    return channel_mesh(mesh_cfg["nx"], mesh_cfg["ny"], mesh_cfg["nz"],
                        length=mesh_cfg["length"],
                        obstacle=mesh_cfg["obstacle"])
