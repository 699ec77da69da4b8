"""Row-partitioned operators over a list of devices, with a halo exchange:
the JAX package's `parallel/partitioned.py` in one process.

The band-ordered operator's rows are cut into P contiguous shards of L rows
each (the last ones padded with zero rows), shard s on `devices[s]`; a
device may hold several shards.  A vector is a `Shards`
(`solvers/vectors.py`): one row block per shard.  The band bounds every
row's columns to its own shard and `h` rows on either side, so each apply
is one exchange, which gives every shard its neighbours' h boundary rows
(zeros beyond the ends; a device-to-device copy where the neighbour lives
on another device), and one launch per shard of the ghost-row form of the
kernel (`halo=g`): K2 for the scalar-DIA operators, K1 for the plane
layout.  The exchange is the JAX package's `ppermute`; `all_gather`
and the fixed-order sums of `solvers/vectors.py` its `all_gather` and
`psum`.

- `partitioned_spmv_dia`: scalar-DIA data (K, L) per shard, x (L,).
- `partitioned_spmv_plane`: the component-plane layout, node-partitioned;
  each shard holds its Lb nodes of every plane, (n_out, n_in * N_D, Lb)
  and x (n_in * Lb,) plane-major.  The ghost width is `ghost_width` of the
  node halo (a whole 16-byte unit: K1's tiled route stays aligned).
- `partitioned_spmv_dia_power`: A^j x, j = 1..k, from ONE k*h-deep exchange
  of x and one (k-1)*h-deep exchange of the operator's columns, then k
  sweeps, each a K2 ghost-row launch on the extended window (the
  communication-avoiding matrix powers of the CA-GMRES basis).
- `ElementPartition`, `partitioned_assemble_dia`: each shard assembles the
  elements whose smallest row it owns into a (K, L + halo) buffer (the
  scatter of `ops/scatter.py`, in a fixed order), then adds its overflow
  columns into its right neighbour's first rows.

The JAX package's block-ELL forms (`RowPartition`, `partitioned_spmv`,
`partitioned_spmv_power`) belong with `sparse/bell.py`, ROADMAP slice 16.
Its pretiled per-shard layout is a TPU layout and is not carried.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.fem.assembly import assemble_dia_values
from navierstokes_tpu_torch.ops import dia as dia_ops
from navierstokes_tpu_torch.ops.plane_dia import ghost_width, spmv_planes
from navierstokes_tpu_torch.solvers.vectors import Shards


def halo_of(offsets: tuple) -> int:
    """max |offset|, at least 1: the rows an apply exchanges per side."""
    return max(max(abs(d) for d in offsets), 1)


def scalar_shard_rows(n: int, offsets: tuple, P: int,
                      multiple: int = 1) -> int:
    """L scalar rows per shard: at least ceil(n / P) and the halo, rounded
    up to `multiple` (4 * agg on 'tl': whole aggregates per shard)."""
    need = max(-(-n // P), halo_of(offsets))
    return -(-need // multiple) * multiple


def plane_shard_nodes(nb: int, node_offsets: tuple, P: int, agg: int,
                      itemsize: int) -> int:
    """Lb nodes per shard of the plane layout: at least ceil(nb / P) and
    the node halo, a multiple of the aggregate (whole aggregates per shard)
    and of a 16-byte unit (K1's tiled route takes the shard's rows)."""
    unit = 16 // itemsize
    m = agg
    while m % unit:
        m += agg
    need = max(-(-nb // P), halo_of(node_offsets))
    return -(-need // m) * m


def split_rows(x: torch.Tensor, L: int, devices) -> Shards:
    """A global vector (..., n) -> P row blocks of L along the last axis,
    zero-padded to P * L, shard s on devices[s]."""
    P = len(devices)
    pad = P * L - x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    return Shards(xp[..., s * L:(s + 1) * L].to(dev).contiguous()
                  for s, dev in enumerate(devices))


def join_rows(v: Shards, n: int, device) -> torch.Tensor:
    """The row blocks back into one vector of n rows on `device`."""
    return torch.cat([a.to(device) for a in v.parts], dim=-1)[..., :n]


def exchange(parts, depth: int) -> list:
    """Each shard's rows with `depth` ghost rows on either side (last axis)
    from its neighbours, zeros beyond the two ends: the JAX package's
    `_exchange`.  depth <= L."""
    if depth == 0:
        return list(parts)
    P = len(parts)
    out = []
    for s, a in enumerate(parts):
        zero = a.new_zeros(a.shape[:-1] + (depth,))
        left = parts[s - 1][..., -depth:].to(a.device) if s else zero
        right = parts[s + 1][..., :depth].to(a.device) if s < P - 1 \
            else zero
        out.append(torch.cat([left, a, right], dim=-1))
    return out


def all_gather(parts, device) -> torch.Tensor:
    """Every shard's block, in shard order, on `device` (axis 0)."""
    return torch.cat([a.to(device) for a in parts])


def _check_fit(h: int, L: int, what: str) -> None:
    if h > L:
        raise ValueError(f"{what} halo {h} exceeds rows-per-device {L}")


def partitioned_spmv_dia(offsets: tuple, data: Shards, x: Shards, *,
                         plain: bool = False) -> Shards:
    """y = A x on scalar-DIA shards: one exchange of h = max|offset| rows
    per side, then one K2 ghost-row launch per shard (its plain version
    with `plain`, or on the CPU).  Padding rows carry zero data and stay
    zero."""
    h = halo_of(offsets)
    _check_fit(h, x.parts[0].shape[0], "scalar")
    spmv = dia_ops.spmv_dia_plain if plain else dia_ops.spmv_dia
    return Shards(spmv(offsets, d, xw, halo=h)
                  for d, xw in zip(data.parts, exchange(x.parts, h)))


def shard_rows(nb: int, Lb: int, P: int) -> list:
    """The live node rows of each shard: nb over shards of Lb."""
    return [min(max(nb - s * Lb, 0), Lb) for s in range(P)]


def partitioned_spmv_plane(node_offsets: tuple, planes: Shards, x: Shards,
                           *, nb: int, n_in: int = 4) -> Shards:
    """y = A x on the node-partitioned component-plane layout: one exchange
    of g = `ghost_width` node rows per side of every input plane, then one
    K1 ghost-row launch per shard (its plain version on the CPU); rows past
    the nb live nodes come out as exact zeros."""
    a0 = planes.parts[0]
    Lb = a0.shape[-1]
    g = ghost_width(node_offsets, a0.element_size())
    _check_fit(halo_of(node_offsets), Lb, "node")
    xs = exchange([v.reshape(n_in, Lb) for v in x.parts], g)
    live = shard_rows(nb, Lb, len(xs))
    return Shards(spmv_planes(node_offsets, p, xw.reshape(-1), n_in=n_in,
                              nb=n, halo=g)
                  for p, xw, n in zip(planes.parts, xs, live))


def partitioned_spmv_dia_power(offsets: tuple, data: Shards, x: Shards,
                               k: int, return_all: bool = False,
                               shifts: tuple = None, *,
                               plain: bool = False) -> Shards:
    """Communication-avoiding A^j x (j = 1..k) on scalar-DIA shards: ONE
    k*h-deep exchange of x and a (k-1)*h-deep one of the operator's
    columns, then k sweeps over the extended window, each one K2 ghost-row
    launch (ghost width h) whose rows then hold valid values one band
    further in; own rows stay valid after every sweep, so `return_all`
    gives the stack (L, k) per shard.  `shifts` (k floats) turns the
    sweeps into the Newton-basis products prod_j (A - shifts[j] I) x.
    Requires k * h <= L."""
    L = x.parts[0].shape[0]
    h = halo_of(offsets)
    D = k * h
    _check_fit(D, L, "k*")
    spmv = dia_ops.spmv_dia_plain if plain else dia_ops.spmv_dia
    out = []
    for cur, d_ext in zip(exchange(x.parts, D),
                          exchange(data.parts, D - h)):
        ext = L + 2 * D
        inner = ext - 2 * h                 # the rows a sweep computes
        own = []
        for s in range(k):
            y = spmv(offsets, d_ext, cur, halo=h)
            if shifts is not None:
                y = y - shifts[s] * cur[h:ext - h]
            # rows [(s+1)h, ext-(s+1)h) of the window are valid now
            nxt = torch.zeros_like(cur)
            nxt[(s + 1) * h:ext - (s + 1) * h] = y[s * h:inner - s * h]
            cur = nxt
            if return_all:
                own.append(cur[D:D + L])
        out.append(torch.stack(own, dim=-1) if return_all else cur[D:D + L])
    return Shards(out)


# ---------------------------------------------------------------------------
# Partitioned assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ElementPartition:
    """Static per-shard element ranges for distributed DIA assembly (the
    JAX package's, field for field).

    Elements go to the shard owning their smallest scalar row; the DIA
    band covers every intra-element node pair, so each shard's scatter
    targets fit a (K, L + halo) buffer, and one add of its `halo` overflow
    columns into its right neighbour completes the sum."""

    n_devices: int
    L: int                        # scalar rows per shard
    halo: int
    n_pad: int                    # n_devices * L
    e_max: int                    # padded elements per shard
    perm: np.ndarray              # (P*e_max,) element id, 0 for pads
    local_map: np.ndarray         # (P*e_max, 256) into (K, L+halo); a pad
                                  # entry is K*(L+halo), the discard slot
    K: int
    ndof: int


def build_element_partition(tets: np.ndarray, dia_elem_map: np.ndarray,
                            ndof: int, K: int, halo: int,
                            n_devices: int) -> ElementPartition:
    ne = tets.shape[0]
    P = n_devices
    L = max(-(-ndof // P), halo)
    n_pad = P * L
    Lh = L + halo

    min_row = 4 * np.asarray(tets).min(axis=1).astype(np.int64)
    dev = np.minimum(min_row // L, P - 1)
    order = np.argsort(dev, kind="stable")
    counts = np.bincount(dev, minlength=P)
    e_max = max(int(counts.max()), 1)

    perm = np.zeros(P * e_max, dtype=np.int64)
    local_map = np.full((P * e_max, 256), K * Lh, dtype=np.int64)
    gmap = np.asarray(dia_elem_map).reshape(ne, 256)
    pos = 0
    for d in range(P):
        c = int(counts[d])
        ids = order[pos:pos + c]
        pos += c
        sl = slice(d * e_max, d * e_max + c)
        perm[sl] = ids
        g = gmap[ids]
        local_map[sl] = (g // ndof) * Lh + (g % ndof - d * L)
    return ElementPartition(n_devices=P, L=L, halo=halo, n_pad=n_pad,
                            e_max=e_max, perm=perm, local_map=local_map,
                            K=K, ndof=ndof)


def shard_element_arrays(ep: ElementPartition, vol, grad, h,
                         devices) -> list:
    """Each shard's element geometry and scatter map on its device: the
    rows ep.perm[s*e_max:(s+1)*e_max] of the global arrays (the pads
    repeat element 0, and scatter into the discard slot)."""
    out = []
    for s, dev in enumerate(devices):
        sl = slice(s * ep.e_max, (s + 1) * ep.e_max)
        ids = torch.as_tensor(ep.perm[sl], device=vol.device)
        out.append({
            "perm": ids.to(dev),
            "vol": vol[ids].to(dev), "grad": grad[ids].to(dev),
            "h": h[ids].to(dev),
            "map": torch.as_tensor(ep.local_map[sl].reshape(-1), device=dev),
        })
    return out


def partitioned_assemble_dia(ep: ElementPartition, arrays: list, dt: float,
                             reynolds: float, delta: float, *,
                             terms: frozenset, UL=None,
                             chunk: int = 16384) -> Shards:
    """Each shard scatters its own elements (`arrays`, from
    `shard_element_arrays`; `UL` the global (ne, 3, 4) nodal velocities of
    the convection terms) into (K, L + halo), in a fixed order; then each
    shard's overflow columns are added into its right neighbour's first
    halo rows.  Returns the (K, L) shards of the (K, n_pad) data."""
    K, L, halo = ep.K, ep.L, ep.halo
    Lh = L + halo
    own, over = [], []
    for a in arrays:
        ul = None if UL is None else UL[a["perm"].to(UL.device)].to(
            a["vol"].device)
        # one extra row of the flat layout holds the discard slot K * Lh
        loc = assemble_dia_values(a["vol"], a["grad"], a["h"], dt, reynolds,
                                  delta, a["map"], terms=terms, K=K + 1,
                                  ndof=Lh, chunk=chunk, UL=ul)[:K]
        own.append(loc[:, :L].contiguous())
        over.append(loc[:, L:])
    for s in range(1, len(own)):
        own[s][:, :halo] += over[s - 1].to(own[s].device)
    return Shards(own)
