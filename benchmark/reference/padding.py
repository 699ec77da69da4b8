"""Frozen copy of the plane layout's padded node count, for the kernel byte
counts.

Vectors on the component-plane layout hold nbp rows per plane: the live
nodes, padded to whole aggregates of the coarse level and then to a
multiple of 128.  The aggregate size follows the measured schedule over
the DoF count (48 up to 150k DoF, 128 up to 600k, 256 above) unless the
configuration sets `coarse_agg`.
"""

from __future__ import annotations

PAD = 128


def aggregate_size(ndof: int) -> int:
    if ndof <= 150_000:
        return 48
    if ndof <= 600_000:
        return 128
    return 256


def plane_rows(nv: int, coarse_agg: int | None = None) -> int:
    """nbp for a mesh of nv nodes."""
    agg = coarse_agg or aggregate_size(4 * nv)
    nb_pad = -(-nv // agg) * agg
    return -(-max(nv, nb_pad, 1) // PAD) * PAD
