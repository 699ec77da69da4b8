"""PETSc ASCII VecView-compatible `.dat` solution files.

The reference dumps one file per time step (`res/solution_stepNNNN.dat`,
`src/solve_newton.c:1286-1293`) in PETSc's default ASCII vector format:

    Vec Object: 1 MPI process
      type: seq
    <value>          (one per line)

Values are `%g`-formatted with PETSc's real-marking rule: a rendered number
without '.', 'e' or a nan/inf marker gets a '.' appended (`0` prints as
`0.`).  The output is byte-identical to the JAX package's writer.
"""

from __future__ import annotations

import numpy as np

HEADER = "Vec Object: 1 MPI process\n  type: seq\n"


def _format_real(v: float) -> str:
    s = "%g" % v
    if not any(c in s for c in ".einEIN"):
        s += "."
    return s


def write_petsc_vec(path: str, vec) -> None:
    """Write a 1-D array (numpy, or a tensor on any device) to `path`."""
    if hasattr(vec, "detach"):
        vec = vec.detach().cpu().numpy()
    vals = np.asarray(vec).reshape(-1)
    with open(path, "w") as f:
        f.write(HEADER)
        f.write("\n".join(_format_real(float(v)) for v in vals))
        f.write("\n")


def read_petsc_vec(path: str) -> np.ndarray:
    with open(path, "r") as f:
        lines = f.read().split("\n")
    vals = [float(x) for x in lines[2:] if x.strip()]
    return np.asarray(vals, dtype=np.float64)
