"""VTK XML output: one ASCII `.vtu` unstructured grid per saved step and a
`.pvd` collection that indexes them (the reference's `res/time_series.pvd`
format).  Velocity is a 3-vector point field and pressure a scalar point
field.  The output is byte-identical to the JAX package's writer for the
same mesh and state.
"""

from __future__ import annotations

import numpy as np

from navierstokes_tpu_torch.mesh.core import Mesh


def _rows_text(a) -> str:
    """One line per row, values `%.9g`, separated by spaces."""
    a = np.asarray(a)
    return "\n".join(" ".join("%.9g" % x for x in row)
                     for row in a.reshape(a.shape[0], -1))


def write_vtu(path: str, mesh: Mesh, u) -> None:
    """Write one snapshot.  u: the (4 nv,) DoF vector in block-node order
    (numpy, or a tensor on any device)."""
    if hasattr(u, "detach"):
        u = u.detach().cpu().numpy()
    u4 = np.asarray(u).reshape(mesh.nv, 4)
    nv, ne = mesh.nv, mesh.ne
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write("  <UnstructuredGrid>\n")
        f.write(f'    <Piece NumberOfPoints="{nv}" NumberOfCells="{ne}">\n')
        f.write("      <Points>\n")
        f.write('        <DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        f.write(_rows_text(mesh.coords))
        f.write("\n        </DataArray>\n      </Points>\n")
        f.write("      <Cells>\n")
        f.write('        <DataArray type="Int32" Name="connectivity" '
                'format="ascii">\n')
        f.write(_rows_text(mesh.tets))
        f.write("\n        </DataArray>\n")
        f.write('        <DataArray type="Int32" Name="offsets" '
                'format="ascii">\n')
        f.write(_rows_text(4 * np.arange(1, ne + 1, dtype=np.int64)[:, None]))
        f.write("\n        </DataArray>\n")
        f.write('        <DataArray type="UInt8" Name="types" '
                'format="ascii">\n')
        f.write(_rows_text(np.full((ne, 1), 10, dtype=np.uint8)))  # tetra
        f.write("\n        </DataArray>\n      </Cells>\n")
        f.write("      <PointData>\n")
        f.write('        <DataArray type="Float64" Name="velocity" '
                'NumberOfComponents="3" format="ascii">\n')
        f.write(_rows_text(u4[:, :3]))
        f.write("\n        </DataArray>\n")
        f.write('        <DataArray type="Float64" Name="pressure" '
                'format="ascii">\n')
        f.write(_rows_text(u4[:, 3:]))
        f.write("\n        </DataArray>\n      </PointData>\n")
        f.write("    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n")


def write_pvd(path: str, entries) -> None:
    """entries: (timestep, file name) pairs, in order."""
    with open(path, "w") as f:
        f.write("<?xml version='1.0' encoding='utf-8'?>\n")
        f.write('<VTKFile type="Collection" version="0.1">\n')
        f.write("  <Collection>\n")
        for ts, name in entries:
            f.write(f'    <DataSet timestep="{ts}" group="" part="0" '
                    f'file="{name}" />\n')
        f.write("  </Collection>\n</VTKFile>\n")
