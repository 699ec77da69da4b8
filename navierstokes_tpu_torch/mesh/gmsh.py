"""Gmsh 2.2 ASCII `.msh` files: the JAX package's reader and writer.

The reader keeps the semantics of the reference's `read_mesh`
(`src/solve_newton.c:91-197`):

- `$Nodes`: a node id and x y z per line; the ids are taken to be 1..nv in
  file order (the id column is not read);
- `$Elements`: type 4 (tetrahedron) is kept; types 2 (triangle) and 3
  (quad) are boundary facets: their tags after the first are scanned for
  the first collected surface tag in {1, 2, 4, 5, 6, 7}, and each facet
  node gets that tag, the last facet to name a node winning; every other
  type is skipped.

`read_gmsh` parses with the native host library (`native/`) where it is
built, else with `read_gmsh_py`, the same semantics in Python.
"""

from __future__ import annotations

import numpy as np

from navierstokes_tpu_torch import native
from navierstokes_tpu_torch.mesh.core import COLLECTED_TAGS, Mesh


def read_gmsh(path: str) -> Mesh:
    """The mesh in the Gmsh 2.2 ASCII file `path`, nodes in file order (no
    reordering)."""
    parsed = native.parse_gmsh_native(path)
    if parsed is None:
        return read_gmsh_py(path)
    coords, tets, tags = parsed
    return Mesh(coords=coords, tets=tets, node_tags=tags)


def read_gmsh_py(path: str) -> Mesh:
    """`read_gmsh` in Python."""
    with open(path, "r") as f:
        lines = f.read().split("\n")

    coords = node_tags = None
    tets = []
    i, n = 0, len(lines)
    while i < n:
        line = lines[i]
        if line.startswith("$Nodes"):
            nv = int(lines[i + 1].split()[0])
            coords = np.empty((nv, 3), dtype=np.float64)
            node_tags = np.full(nv, -1, dtype=np.int32)
            for k in range(nv):
                parts = lines[i + 2 + k].split()
                coords[k] = [float(parts[1]), float(parts[2]), float(parts[3])]
            i += 2 + nv
            continue
        if line.startswith("$Elements"):
            total = int(lines[i + 1].split()[0])
            for k in range(total):
                parts = lines[i + 2 + k].split()
                etype, ntags = int(parts[1]), int(parts[2])
                tags = [int(x) for x in parts[3:3 + ntags]]
                verts = [int(x) - 1 for x in parts[3 + ntags:]]
                if etype == 4:
                    tets.append(verts[:4])
                elif etype in (2, 3):
                    # the first collected tag after tags[0]
                    # (`src/solve_newton.c:166-172`)
                    surface = next((t for t in tags[1:]
                                    if t in COLLECTED_TAGS), -1)
                    if surface != -1:
                        for v in verts[:3 if etype == 2 else 4]:
                            node_tags[v] = surface
            i += 2 + total
            continue
        i += 1

    if coords is None:
        raise ValueError(f"no $Nodes section found in {path}")
    tets_arr = (np.asarray(tets, dtype=np.int32) if tets
                else np.empty((0, 4), dtype=np.int32))
    return Mesh(coords=coords, tets=tets_arr, node_tags=node_tags)


_FACES = np.array([(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)])


def write_gmsh(mesh: Mesh, path: str) -> None:
    """Write a Gmsh 2.2 ASCII file: the nodes, the tets, and as triangles
    the boundary faces (tet faces met once) whose three nodes share one
    collected tag, in the order the faces are first met.  The output is
    byte-identical to the JAX package's `write_gmsh`.

    The JAX package's documented limitation holds: a face whose nodes carry
    different tags is dropped (a facet tags all its vertices, so writing it
    would overwrite a neighbouring surface's tags under the reader's
    last-writer-wins rule).  A round trip never gives a node a wrong tag,
    but a node whose every boundary face is mixed comes back with -1."""
    faces = np.sort(mesh.tets[:, _FACES].reshape(-1, 3), axis=1)
    _, first, counts = np.unique(faces, axis=0, return_index=True,
                                 return_counts=True)
    boundary = faces[np.sort(first[counts == 1])]
    tags = mesh.node_tags[boundary]
    keep = (tags.min(axis=1) == tags.max(axis=1)) & np.isin(tags[:, 0],
                                                             COLLECTED_TAGS)
    tris, tri_tags = boundary[keep] + 1, tags[keep, 0]

    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{mesh.nv}\n")
        for i, (x, y, z) in enumerate(mesh.coords):
            f.write(f"{i + 1} {x:.16g} {y:.16g} {z:.16g}\n")
        f.write("$EndNodes\n")
        elems = [f"{e + 1} 2 2 {t} {t} {a} {b} {c}"
                 for e, (t, (a, b, c)) in enumerate(zip(tri_tags, tris))]
        eid = len(elems) + 1
        elems += [f"{eid + e} 4 2 0 0 {a} {b} {c} {d}"
                  for e, (a, b, c, d) in enumerate(mesh.tets + 1)]
        f.write(f"$Elements\n{len(elems)}\n")
        f.write("\n".join(elems))
        f.write("\n$EndElements\n")
