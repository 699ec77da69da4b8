"""Matrix generator, the `src/create_mat.c` equivalent: the JAX package's
`bench/create_mat.py` with the same flags, plus `--device`.

Assembles the operator of `--terms` for a mesh of the scaling series (or a
Gmsh file) at u = 0, applies the Dirichlet rows (`zero_rows_bcsr`), copies
it to the host once and writes it the reference's three ways
(`src/create_mat.c:376-484`): AIJ by component (node + comp * nv,
`_aij.mtx`), AIJ block-node scalar (4 node + comp, `_aijp.mtx`) and BAIJ4
block-node (`_baij4.mtx`, the same entries), with the block structure in
`_baij4.npz`.  The assembly runs in `--dtype` (float64 by default) on
`--device`; the H100 runs float64 natively, so nothing is pinned to the
CPU.

Usage:
    python -m navierstokes_tpu_torch.bench.create_mat --matrix-id 3 \
        --out mat/ [--device cuda]
    python -m navierstokes_tpu_torch.bench.create_mat --msh mesh.msh \
        --out mat/
"""

from __future__ import annotations

import argparse
import os

import torch

from navierstokes_tpu_torch import native
from navierstokes_tpu_torch.fem.assembly import (
    FULL_JACOBIAN_TERMS,
    LINEAR_TERMS,
    STOKES_TERMS,
    assemble_operator,
    build_discretization,
)
from navierstokes_tpu_torch.fem.dirichlet import zero_rows_bcsr
from navierstokes_tpu_torch.io.mtx import (
    save_bcsr_npz,
    write_mtx,
    write_mtx_by_component,
)
from navierstokes_tpu_torch.mesh.box import scaling_series_mesh
from navierstokes_tpu_torch.mesh.gmsh import read_gmsh
from navierstokes_tpu_torch.sparse.bcsr import BCSR4

TERMS = {"stokes": STOKES_TERMS, "linear": LINEAR_TERMS,
         "full": FULL_JACOBIAN_TERMS}
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def main(argv=None) -> dict:
    """Write the four files; returns their paths by suffix ('aij',
    'aijp', 'baij4', 'npz')."""
    p = argparse.ArgumentParser(description="matrix generator (PyTorch "
                                            "port)")
    p.add_argument("--matrix-id", type=int, default=None)
    p.add_argument("--msh", default=None)
    p.add_argument("--out", default="mat")
    p.add_argument("--terms", default="linear", choices=sorted(TERMS))
    p.add_argument("--dtype", default="float64", choices=sorted(_DTYPES))
    p.add_argument("--dt", type=float, default=0.001)
    p.add_argument("--reynolds", type=float, default=300.0)
    p.add_argument("--delta", type=float, default=0.05)
    p.add_argument("--device", default="cuda",
                   help="torch device of the assembly: cuda (default) or "
                        "cpu")
    args = p.parse_args(argv)
    if (args.matrix_id is None) == (args.msh is None):
        p.error("exactly one of --matrix-id / --msh required")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda but no CUDA device is available "
                "(pass --device cpu to run on the CPU)")

    mesh = (read_gmsh(args.msh) if args.msh
            else scaling_series_mesh(args.matrix_id))
    name = (os.path.splitext(os.path.basename(args.msh))[0] if args.msh
            else f"matrix{args.matrix_id}")
    dtype = _DTYPES[args.dtype]
    disc = build_discretization(mesh, dtype, device)
    print(f"pattern build: {native.backend()}", flush=True)
    u0 = torch.zeros(disc.ndof, dtype=dtype, device=device)
    op = assemble_operator(disc, u0, args.dt, args.reynolds, args.delta,
                           TERMS[args.terms])
    values = zero_rows_bcsr(op.values, disc.row_ids, disc.indices,
                            disc.diag_slots, disc.bc.row_bc)
    op = BCSR4(indptr=op.indptr, indices=op.indices, values=values.cpu())

    os.makedirs(args.out, exist_ok=True)
    paths = {kind: os.path.join(args.out, f"{name}_{kind}.mtx")
             for kind in ("aij", "aijp", "baij4")}
    paths["npz"] = os.path.join(args.out, f"{name}_baij4.npz")
    write_mtx_by_component(paths["aij"], op, mesh.nv)
    write_mtx(paths["aijp"], op)
    write_mtx(paths["baij4"], op)
    save_bcsr_npz(paths["npz"], op)
    print(f"wrote {paths['aij']}, {paths['aijp']}, {paths['baij4']} and "
          f"{paths['npz']}: {disc.ndof} rows, {op.nnz} nonzeros", flush=True)
    return paths


if __name__ == "__main__":
    main()
