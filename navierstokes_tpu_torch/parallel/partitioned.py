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

- `RowPartition`, `partitioned_spmv`, `partitioned_spmv_power`: the
  block-ELL operator (`sparse/bell.py`) in shards of L block rows, the pad
  rows identity blocks.  Columns are kept as deltas col - row in [-H, H],
  so a shard gathers its ghost rows with the same arithmetic as its own
  from its (L + 2H, 4) window; the power form exchanges k*H rows of x and
  (k-1)*H of the operator once, then sweeps k times over a shrinking
  ghost region.  Plain PyTorch, as in the JAX package (no Pallas kernel
  reaches the block-ELL product); no solver path calls them.

The JAX package's pretiled per-shard layout is a TPU layout and is not
carried.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.fem.assembly import assemble_dia_values
from navierstokes_tpu_torch.ops import dia as dia_ops
from navierstokes_tpu_torch.ops.plane_dia import ghost_width, spmv_planes
from navierstokes_tpu_torch.ops.spmv import bell_rows
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


def split_rows(x: torch.Tensor, L: int, devices, dim: int = -1) -> Shards:
    """A global array -> P row blocks of L along axis `dim` (the last by
    default), zero-padded to P * L, shard s on devices[s]."""
    P = len(devices)
    pad = P * L - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    return Shards(x.narrow(dim, s * L, L).to(dev).contiguous()
                  for s, dev in enumerate(devices))


def join_rows(v: Shards, n: int, device, dim: int = -1) -> torch.Tensor:
    """The row blocks back into one array of n rows along `dim` on
    `device`."""
    return torch.cat([a.to(device) for a in v.parts], dim=dim).narrow(
        dim, 0, n)


def exchange(parts, depth: int, dim: int = -1) -> list:
    """Each shard's rows with `depth` ghost rows on either side (along
    `dim`, the last axis by default) from its neighbours, zeros beyond the
    two ends: the JAX package's `_exchange`.  depth <= L."""
    if depth == 0:
        return list(parts)
    P = len(parts)
    out = []
    for s, a in enumerate(parts):
        shape = list(a.shape)
        shape[dim] = depth
        zero = a.new_zeros(shape)
        n = a.shape[dim]
        left = parts[s - 1].narrow(dim, n - depth, depth).to(a.device) \
            if s else zero
        right = parts[s + 1].narrow(dim, 0, depth).to(a.device) \
            if s < P - 1 else zero
        out.append(torch.cat([left, a, right], dim=dim))
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
# Block-ELL
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RowPartition:
    """Static block-ELL partition layout (host side), the JAX package's
    field for field."""

    n_devices: int
    rows_per_dev: int            # L (block rows per shard)
    halo: int                    # H (block rows exchanged per side)
    nb: int                      # true block rows
    nb_pad: int                  # n_devices * L
    slots: int
    delta_indices: np.ndarray    # (nb_pad, S) int32: col - row in [-H, H]
    pad_diag_slot: int = 0       # slot holding identity in padding rows


def build_row_partition(ell_indices: np.ndarray, n_devices: int,
                        halo: int = None) -> RowPartition:
    """Cut a block-ELL pattern into contiguous shards of L block rows.

    Requires the band max |col - row| <= halo <= L (a ValueError names the
    one that fails); padding rows reference themselves (delta 0)."""
    nb, slots = ell_indices.shape
    L = -(-nb // n_devices)
    nb_pad = L * n_devices
    delta = ell_indices.astype(np.int64) - np.arange(nb, dtype=np.int64)[
        :, None]
    bw = int(np.abs(delta).max()) if nb else 0
    if halo is None:
        halo = bw
    if bw > halo:
        raise ValueError(f"block bandwidth {bw} exceeds halo {halo}")
    if halo > L:
        raise ValueError(
            f"halo {halo} exceeds rows-per-device {L}: too many devices for "
            "this mesh bandwidth (refine the mesh or reduce n_devices)")
    delta_pad = np.zeros((nb_pad, slots), dtype=np.int32)
    delta_pad[:nb] = delta
    return RowPartition(n_devices=n_devices, rows_per_dev=L, halo=halo,
                        nb=nb, nb_pad=nb_pad, slots=slots,
                        delta_indices=delta_pad)


def pad_ell_values(part: RowPartition, values: torch.Tensor) -> torch.Tensor:
    """(nb, S, 4, 4) -> (nb_pad, S, 4, 4) with identity blocks in the pad
    rows' `pad_diag_slot`."""
    n_pad = part.nb_pad - part.nb
    if n_pad == 0:
        return values
    pad = values.new_zeros((n_pad, part.slots, 4, 4))
    pad[:, part.pad_diag_slot] = torch.eye(4, dtype=values.dtype,
                                           device=values.device)
    return torch.cat([values, pad])


def pad_vector(part: RowPartition, x: torch.Tensor) -> torch.Tensor:
    """(4 nb,) -> (4 nb_pad,), zeros in the pad rows."""
    return torch.nn.functional.pad(x, (0, 4 * (part.nb_pad - part.nb)))


def unpad_vector(part: RowPartition, x: torch.Tensor) -> torch.Tensor:
    return x[:4 * part.nb]


def _bell_window(vals: torch.Tensor, window: torch.Tensor,
                 gather_at: torch.Tensor) -> torch.Tensor:
    """sum_s vals[q, s] @ window[gather_at[q, s]] -> (rows, 4)."""
    return bell_rows(vals, window[gather_at][..., None])[..., 0]


def partitioned_spmv(part: RowPartition, delta: Shards, values: Shards,
                     x: Shards) -> Shards:
    """y = A x on block-ELL shards with one exchange of H block rows per
    side: each shard gathers from its (L + 2H, 4) window at q + delta + H.
    Per shard: delta (L, S) of `part.delta_indices`, values (L, S, 4, 4)
    of `pad_ell_values`, x (L, 4) of `pad_vector`, each cut by
    `split_rows(..., dim=0)`; y (L, 4)."""
    H, L = part.halo, part.rows_per_dev
    out = []
    for d, v, xw in zip(delta.parts, values.parts,
                        exchange(x.parts, H, dim=0)):
        q = torch.arange(L, device=xw.device)[:, None]
        out.append(_bell_window(v, xw, q + d + H))
    return Shards(out)


def partitioned_spmv_power(part: RowPartition, delta: Shards, values: Shards,
                           x: Shards, k: int, return_all: bool = False,
                           shifts: tuple = None) -> Shards:
    """Communication-avoiding A^k x on block-ELL shards: ONE k*H-deep
    exchange of x and one (k-1)*H-deep exchange of the operator rows and
    their deltas, then k local sweeps.  Sweep s leaves valid rows at window
    offsets [(s+1)H, L + 2D - (s+1)H) (D = kH), so the own rows [D, D + L)
    are valid after every sweep: `return_all` gives (L, 4, k) per shard.
    `shifts` (k floats) gives the Newton-basis products
    prod_j (A - shifts[j] I) x.  Requires k * H <= L."""
    H, L = part.halo, part.rows_per_dev
    D = k * H
    if D > L:
        raise ValueError(f"k*halo = {D} exceeds rows-per-device {L}")
    if shifts is None and k == 1 and not return_all:
        return partitioned_spmv(part, delta, values, x)
    ghost = D - H            # operator rows needed beyond the shard's own
    ext = L + 2 * D
    out = []
    for cur, d_ext, v_ext in zip(exchange(x.parts, D, dim=0),
                                 exchange(delta.parts, ghost, dim=0),
                                 exchange(values.parts, ghost, dim=0)):
        dev = cur.device
        # the row at window offset p in [H, ext - H) is operator row p - H
        # of the extended arrays and gathers at p + delta
        q = torch.arange(ext - 2 * H, device=dev)[:, None]
        gather_at = torch.clamp(q + H + d_ext, 0, ext - 1)
        off = torch.arange(ext, device=dev)[:, None]
        own = []
        for s in range(k):
            y = _bell_window(v_ext, cur, gather_at)
            if shifts is not None:
                y = y - shifts[s] * cur[H:ext - H]
            y = torch.nn.functional.pad(y, (0, 0, H, H))
            valid = (off >= (s + 1) * H) & (off < ext - (s + 1) * H)
            cur = torch.where(valid, y, torch.zeros_like(y))
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
