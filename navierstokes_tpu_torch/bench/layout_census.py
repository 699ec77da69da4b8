"""Operator-layout storage census over the scaling-series matrices: the JAX
package's `bench/layout_census.py`, with the same columns.

The SpMV is bound by the bytes it streams, so a layout wins by moving
fewer of them without gathers.  From the real block pattern of each
matrix (built by the native host library where it is built, `native/`)
this counts the values each candidate stores:

  raw/BAIJ4   nnzb * 16              compact, but gathers block columns
  scalar-DIA  K * ndof               K scalar diagonals, no gathers (K2)
  block-DIA   N_D * 16 * nb          dense 4x4 blocks on the N_D node
                                     diagonals: the plane layout (K1)

A node diagonal covers 7 scalar diagonals and its neighbour shares 3 of
them, so a band without holes gives K = 4 N_D + 3 (column `4N_D+3`).
Host numpy only: nothing runs on a device.  `benchlogs/layout_census.txt`
holds the JAX package's table for matrices 1-8; every column but
`build_s` must be equal.

Usage:
    python -m navierstokes_tpu_torch.bench.layout_census [--max-id 8] \
        [--ids 1,2,3]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from navierstokes_tpu_torch import native
from navierstokes_tpu_torch.fem.assembly import block_pattern
from navierstokes_tpu_torch.mesh.box import scaling_series_mesh
from navierstokes_tpu_torch.sparse.dia import build_dia_pattern


def census_one(matrix_id: int) -> dict:
    """One row of the census; `build_s` is the host seconds of the block
    and DIA pattern builds."""
    mesh = scaling_series_mesh(matrix_id)
    t0 = time.perf_counter()
    indptr, indices, _ = block_pattern(mesh)
    pat = build_dia_pattern(indptr, indices)
    row_ids = np.repeat(np.arange(mesh.nv, dtype=np.int64), np.diff(indptr))
    nd = len(np.unique(indices.astype(np.int64) - row_ids))
    nb, nnzb, ndof = mesh.nv, len(indices), 4 * mesh.nv
    k = pat.K
    mb = 4e-6  # f32 bytes -> MB
    return {
        "id": matrix_id, "ndof": ndof, "nnzb": nnzb, "K": k, "N_D": nd,
        "span_contig": 4 * nd + 3,     # K if the node band had no holes
        "raw_mb": round(nnzb * 16 * mb, 1),
        "dia_mb": round(k * ndof * mb, 1),
        "bdia_mb": round(nd * 16 * nb * mb, 1),
        "bdia_vs_dia": round((nd * 16 * nb) / (k * ndof), 3),
        "build_s": round(time.perf_counter() - t0, 1),
    }


def main(argv=None) -> list:
    """Print the census table; returns its rows (`census_one`)."""
    p = argparse.ArgumentParser(description="operator-layout census "
                                            "(PyTorch port)")
    p.add_argument("--max-id", type=int, default=10)
    p.add_argument("--ids", type=str, default=None,
                   help="comma-separated matrix ids (overrides --max-id)")
    args = p.parse_args(argv)
    ids = ([int(t) for t in args.ids.split(",")] if args.ids
           else range(1, args.max_id + 1))
    print(f"pattern build: {native.backend()}", flush=True)
    print(f"{'id':>2} {'ndof':>9} {'nnzb':>9} {'K':>4} {'N_D':>4} "
          f"{'4N_D+3':>6} {'raw MB':>8} {'DIA MB':>8} {'bDIA MB':>8} "
          f"{'bDIA/DIA':>8}", flush=True)
    rows = []
    for mid in ids:
        r = census_one(mid)
        print(f"{r['id']:>2} {r['ndof']:>9} {r['nnzb']:>9} {r['K']:>4} "
              f"{r['N_D']:>4} {r['span_contig']:>6} {r['raw_mb']:>8} "
              f"{r['dia_mb']:>8} {r['bdia_mb']:>8} {r['bdia_vs_dia']:>8}",
              flush=True)
        rows.append(r)
    return rows


if __name__ == "__main__":
    main()
