"""Bytes of the kernels the per-layer metrics hold against the roofline,
from their shapes alone, and the table of the cards' peaks (`peaks.json`).

K1, the plane SpMV, reads its operator (n_out x n_in * N_D planes of nbp
rows), its input vector (n_in planes) and writes its output (n_out
planes): each input byte read once, each output byte written once.  K2,
the scalar-DIA SpMV, reads its K diagonals of n rows, its input vector (n
rows and a ghost halo each side) and writes its output (n rows); its data
may be stored narrower than x (a bf16 operator with an f32 x).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"
# K1's kernels in a device trace: both routes, every dtype
K1_KERNEL = "plane_spmv_"


def k1_bytes(n_out: int, n_in: int, n_offsets: int, nbp: int,
             itemsize: int, halo: int = 0) -> int:
    """Least bytes one K1 launch moves."""
    return itemsize * (n_out * n_in * n_offsets * nbp
                       + n_in * (nbp + 2 * halo) + n_out * nbp)


def k2_bytes(n_diagonals: int, n: int, data_itemsize: int,
             x_itemsize: int, halo: int = 0) -> int:
    """Least bytes one K2 launch moves."""
    return (n_diagonals * n * data_itemsize
            + x_itemsize * (n + 2 * halo) + x_itemsize * n)


def peak(kind: str, key: str):
    """The published peak `key` of the card named `kind`, or None."""
    with open(PEAKS) as f:
        table = json.load(f)
    return table.get(kind, {}).get(key)
