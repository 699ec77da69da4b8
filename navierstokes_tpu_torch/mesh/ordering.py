"""Node reordering for a narrow operator band: reverse Cuthill-McKee, the
JAX package's numpy version.

The DIA kernels take a band of at most 128 node offsets (K1) or 256 scalar
diagonals (K2); a mesh numbered without locality (a Gmsh file) can exceed
it, and RCM narrows it.  The generator meshes come numbered near-optimally
already.  As in the JAX package, nothing on the single-device path calls
these (`run.py --msh` reads without reordering).  `rcm_ordering` runs the
native host library's RCM (`native/`) where it is built, else
`rcm_ordering_py`; the two give the same permutation.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from navierstokes_tpu_torch import native
from navierstokes_tpu_torch.mesh.core import Mesh


def _adjacency_lists(nv: int, rows: np.ndarray, cols: np.ndarray) -> tuple:
    """CSR adjacency (ptr, neighbours) from symmetric COO, self pairs
    dropped."""
    mask = rows != cols
    r, c = rows[mask], cols[mask]
    order = np.argsort(r, kind="stable")
    r, c = r[order], c[order]
    ptr = np.zeros(nv + 1, dtype=np.int64)
    np.add.at(ptr, r + 1, 1)
    return np.cumsum(ptr), c


def rcm_ordering(mesh: Mesh) -> np.ndarray:
    """Reverse Cuthill-McKee permutation, perm[new] = old node index: a
    breadth-first walk of each component from a node of least degree,
    neighbours by increasing degree (stable), then reversed."""
    built = native.build_pattern_native(mesh.nv, mesh.tets)
    if built is None:
        return rcm_ordering_py(mesh)
    indptr, indices, _ = built
    return native.rcm_native(mesh.nv, indptr, indices)


def rcm_ordering_py(mesh: Mesh) -> np.ndarray:
    """`rcm_ordering` in numpy and Python."""
    rows, cols = mesh.node_adjacency()
    nv = mesh.nv
    ptr, adj = _adjacency_lists(nv, rows, cols)
    degree = np.diff(ptr)

    visited = np.zeros(nv, dtype=bool)
    order = []
    remaining = np.argsort(degree, kind="stable")
    pos = 0
    while len(order) < nv:
        while pos < len(remaining) and visited[remaining[pos]]:
            pos += 1
        start = remaining[pos]
        visited[start] = True
        q = deque([start])
        while q:
            u = q.popleft()
            order.append(u)
            nbrs = adj[ptr[u]:ptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                q.extend(nbrs.tolist())
    return np.asarray(order[::-1], dtype=np.int32)


def reorder_mesh(mesh: Mesh, perm: np.ndarray) -> Mesh:
    """The mesh renumbered so that new node i is old node perm[i]."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return Mesh(coords=mesh.coords[perm], tets=inv[mesh.tets],
                node_tags=mesh.node_tags[perm])


def block_bandwidth(mesh: Mesh) -> int:
    """max |i - j| over adjacent node pairs: the operator's block
    bandwidth."""
    rows, cols = mesh.node_adjacency()
    if len(rows) == 0:
        return 0
    return int(np.max(np.abs(rows.astype(np.int64) - cols.astype(np.int64))))


def best_ordering(mesh: Mesh) -> np.ndarray:
    """The natural order or RCM, whichever gives the narrower band."""
    identity = np.arange(mesh.nv, dtype=np.int32)
    rcm = rcm_ordering(mesh)
    if block_bandwidth(reorder_mesh(mesh, rcm)) < block_bandwidth(mesh):
        return rcm
    return identity
