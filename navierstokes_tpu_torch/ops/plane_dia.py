"""Component-plane DIA SpMV: the operator layout of the flagship path.

With vectors stored as contiguous component planes (u | v | w | p, each of
nbp nodes), the 4x4-blocked FEM operator becomes n_out x n_in plane
couplings, each a band over the N_D node offsets D:

    y_a[i] = sum_{b, D}  V[a, j(b, D)][i] * x_b[i + D]

with j(b, D) = iD * n_in + b (`plane_terms`).  The operator is stored as
(n_out, n_in * N_D, nbp) planes; rows nb <= i < nbp are padding and hold
zeros.  `spmv_planes` applies it through the CUDA kernel K1
(`csrc/plane_dia.cu`) for tensors on the card, and through the plain
PyTorch version `spmv_planes_plain` for tensors on the CPU.

K1 has two routes that compute the same function (`plane_route` picks one
by the operator's shape and alignment alone): 'tiled', which streams the
operator through a shared-memory ring of bulk copies, tile by tile, with
the x window of a tile in shared memory; and 'rows', one thread per node
row, which takes every shape.

The ghost-row form (`halo=g > 0`, the JAX package's `x_prehalo=True`):
each plane of x holds nbp + 2g values, x_b[g + j] for j in [-g, nbp + g),
where the distributed solver's halo exchange has put the neighbouring
shards' rows (`parallel/partitioned.py`); with g >= max|D| nothing is
masked.  The tiled route takes it where g is a multiple of 16 bytes
(`ghost_width` rounds the halo up to that), else the rows route runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from navierstokes_tpu_torch.ops import band_ring, cuda_lib

PAD = 128   # nbp granularity: whole 128-thread kernel blocks, aligned rows
MAX_OFFSETS = 128         # kMaxOffsets of csrc/plane_dia.cu
MAX_TILE = 512            # kMaxTile: rows of a tile, one consumer thread each
ROUTES = ("tiled", "rows")

# Plain integer counters: K1 launches (all, by route, those of the ghost-row
# form, and by form: "n_out x n_in", number of node offsets, route, and
# "halo" for the ghost-row form), and calls of the plain version.
kernel_launches = 0
halo_launches = 0
route_launches = dict.fromkeys(ROUTES, 0)
form_launches: dict = {}
plain_calls = 0


def reset_counters() -> None:
    global kernel_launches, halo_launches, plain_calls
    kernel_launches = 0
    halo_launches = 0
    plain_calls = 0
    for route in ROUTES:
        route_launches[route] = 0
    form_launches.clear()


def node_offsets_from_scalar(offsets: tuple) -> tuple:
    """Block (node) offsets D from the scalar-DIA offset set.

    A 4x4 block at node offset D always populates scalar diagonal 4D, and
    4D is in the scalar set only through a real block offset.  Every scalar
    diagonal must be covered by some block offset (dense node blocks)."""
    ks = set(offsets)
    cands = tuple(sorted(d for d in range(min(offsets) // 4 - 1,
                                          max(offsets) // 4 + 2)
                         if 4 * d in ks))
    cover = {4 * d + e for d in cands for e in range(-3, 4)}
    missing = ks - cover
    if missing:
        raise ValueError(f"scalar diagonals {sorted(missing)} not covered "
                         "by any node offset (non-dense blocks?)")
    return cands


def plane_terms(node_offsets: tuple, n_in: int = 4) -> tuple:
    """Static term list [(b, D), ...] shared by all output planes."""
    return tuple((b, d) for d in node_offsets for b in range(n_in))


def plane_nbp(nb: int, nb_pad: int = 0) -> int:
    """Padded node count of the plane layout: at least the live nodes and
    the aggregation padding `n_agg * agg`, rounded up to `PAD`."""
    n = max(nb, nb_pad, 1)
    return -(-n // PAD) * PAD


def extract_planes(offsets: tuple, data: torch.Tensor, nb: int,
                   node_offsets=None, nbp=None) -> torch.Tensor:
    """Scalar-DIA (K, 4*nb) data -> plane data (4, NT, nb), or (4, NT, nbp)
    zero-padded when `nbp` is given.

    planes[a, j] with terms[j] = (b, D) holds A[4i+a, 4(i+D)+b] for each
    node row i: scalar diagonal k = 4D + (b - a), rows 4i + a (the stride-4
    slice data[k][a::4]).  Diagonals absent from the set are zero planes."""
    if node_offsets is None:
        node_offsets = node_offsets_from_scalar(offsets)
    terms = plane_terms(node_offsets)
    kidx = {k: i for i, k in enumerate(offsets)}
    width = nb if nbp is None else nbp
    planes = torch.zeros((4, len(terms), width), dtype=data.dtype,
                         device=data.device)
    for a in range(4):
        for j, (b, d) in enumerate(terms):
            k = 4 * d + (b - a)
            if k in kidx:
                planes[a, j, :nb] = data[kidx[k], a::4]
    return planes


def to_planes(x: torch.Tensor, nb: int, nbp: int) -> torch.Tensor:
    """Interleaved (4*nb,) -> flat plane-major (4*nbp,) (zero-padded)."""
    out = torch.zeros((4, nbp), dtype=x.dtype, device=x.device)
    out[:, :nb] = x.reshape(nb, 4).T
    return out.reshape(-1)


def from_planes(xp: torch.Tensor, nb: int, nbp: int) -> torch.Tensor:
    """Flat plane-major (4*nbp,) -> interleaved (4*nb,)."""
    return xp.reshape(4, nbp)[:, :nb].T.reshape(-1)


def ghost_width(node_offsets: tuple, itemsize: int) -> int:
    """The ghost rows a shard's x carries on either side of each plane: the
    node halo max|D| (at least 1) rounded up to whole 16-byte units, so that
    the planes of a shard whose row count is a multiple of 16 bytes stay
    aligned for the tiled route's bulk copies."""
    unit = band_ring.COPY_ALIGN // itemsize
    h = max(max(abs(d) for d in node_offsets), 1)
    return -(-h // unit) * unit


def _check(node_offsets, data: torch.Tensor, x: torch.Tensor, n_in: int,
           nb: int, halo: int = 0):
    if data.dim() != 3:
        raise ValueError(f"plane data must be (n_out, NT, nbp), got "
                         f"{tuple(data.shape)}")
    n_out, nt, nbp = data.shape
    if not (1 <= n_out <= 4 and 1 <= n_in <= 4):
        raise ValueError(f"n_out={n_out}, n_in={n_in}: both must be in 1..4")
    if not 1 <= len(node_offsets) <= MAX_OFFSETS:
        raise ValueError(f"{len(node_offsets)} node offsets; K1 takes "
                         f"1..{MAX_OFFSETS}")
    if nt != n_in * len(node_offsets):
        raise ValueError(f"NT={nt} != n_in * N_D = {n_in * len(node_offsets)}")
    band = max(abs(d) for d in node_offsets)
    if halo < 0 or (halo and halo < band):
        raise ValueError(f"ghost width {halo}: 0, or at least the band's "
                         f"{band}")
    if x.shape != (n_in * (nbp + 2 * halo),):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"({n_in * (nbp + 2 * halo)},)")
    if not 0 <= nb <= nbp:
        raise ValueError(f"nb={nb} outside [0, nbp={nbp}]")
    if data.dtype != x.dtype:
        raise TypeError(f"dtype mismatch: data {data.dtype}, x {x.dtype}")
    if data.device != x.device:
        raise ValueError(f"device mismatch: data {data.device}, x {x.device}")
    return n_out, nbp


def spmv_planes_plain(node_offsets: tuple, data: torch.Tensor,
                      x: torch.Tensor, *, n_in: int, nb: int,
                      halo: int = 0) -> torch.Tensor:
    """Plain PyTorch K1: the loop of shifted-slice multiply-adds.

    Same terms in the same order as the kernel; x_b[i + D] counts as zero
    outside [0, nbp) (with `halo` > 0 it comes from the ghost rows) and rows
    >= nb come out as exact zeros."""
    global plain_calls
    n_out, nbp = _check(node_offsets, data, x, n_in, nb, halo)
    plain_calls += 1
    acc_dtype = torch.promote_types(data.dtype, torch.float32)
    xs = x.reshape(n_in, nbp + 2 * halo).to(acc_dtype)
    y = torch.zeros((n_out, nbp), dtype=acc_dtype, device=x.device)
    j = 0
    for d in node_offsets:
        lo, hi = (0, nbp) if halo else (max(0, -d), min(nbp, nbp - d))
        for b in range(n_in):
            if hi > lo:
                y[:, lo:hi] += data[:, j, lo:hi].to(acc_dtype) \
                    * xs[b, halo + lo + d:halo + hi + d]
            j += 1
    y[:, nb:] = 0
    return y.to(x.dtype).reshape(-1)


class TilePlan(NamedTuple):
    """The tiled route's launch: `tn` rows per tile, `n_tiles` tiles walked
    by `grid` persistent blocks, a ring of `stages` slots (one slot: the
    n_out * n_in row segments of `group` consecutive node offsets), `windows`
    x window buffers (two where a block walks several tiles) of `window`
    values per input plane in the segments `clusters` ((lo, hi) node
    offsets, `band_ring.window_clusters`), `smem_bytes` of dynamic shared
    memory."""

    tn: int
    n_tiles: int
    grid: int
    group: int
    stages: int
    clusters: tuple
    window: int
    windows: int
    smem_bytes: int


def plan_text(plan: TilePlan) -> str:
    """One line of a tile plan, as the card's checks print it."""
    return (f"tile {plan.tn}, {plan.n_tiles} tiles on {plan.grid} blocks, "
            f"G {plan.group}, {len(plan.clusters)} clusters, {plan.stages} "
            f"stages, window {plan.window}, {plan.smem_bytes} B")


@functools.lru_cache(maxsize=256)
def tile_plan(node_offsets: tuple, n_out: int, n_in: int, nbp: int,
              itemsize: int, n_sm: int = band_ring.N_SM,
              halo: int = 0) -> TilePlan | None:
    """The tiled route's plan for an (n_out, n_in * N_D, nbp) operator (x
    with `halo` ghost rows on either side of each plane), or None where the
    shape does not fit the route: a row of nbp values, or the ghost width,
    is not a multiple of 16 bytes (a bulk copy's alignment), or the x
    window and two stages of one offset do not fit shared memory.

    Tiles fill the card in whole waves of one block per SM (`wave_tile`),
    up to MAX_TILE rows, or half that and so on where a larger tile does
    not fit; tile t owns rows [t * tn, min((t + 1) * tn, nbp)) and reads,
    for each cluster (lo, hi), x_b[t * tn + lo .. t * tn + tn + hi), zero
    outside [0, nbp), the clusters split where offsets are more than tn
    apart.  A stage carries `stage_group` node offsets, about
    `band_ring.SLOT_BYTES`.  Cached: a solver loop asks for the same plan
    at every launch."""
    if (nbp * itemsize) % band_ring.COPY_ALIGN \
            or (halo * itemsize) % band_ring.COPY_ALIGN:
        return None
    max_tile = MAX_TILE
    while max_tile >= band_ring.WARP:
        tn = band_ring.wave_tile(nbp, n_sm, max_tile)
        max_tile //= 2
        clusters = band_ring.window_clusters(node_offsets, tn, itemsize)
        n_tiles = -(-nbp // tn)
        grid = min(n_tiles, n_sm)
        window = band_ring.window_values(tn, clusters)
        windows = band_ring.window_buffers(n_tiles, grid)
        window_bytes = windows * n_in * window * itemsize
        offset_bytes = n_out * n_in * tn * itemsize
        group = band_ring.stage_group(
            offset_bytes, len(node_offsets),
            band_ring.SMEM_LIMIT - band_ring.HEADER_BYTES - window_bytes)
        if not group:
            continue
        slot_bytes = group * offset_bytes
        stages = band_ring.ring_stages(slot_bytes, window_bytes)
        return TilePlan(tn, n_tiles, grid, group, stages, clusters,
                        window, windows,
                        band_ring.smem_bytes(stages, slot_bytes,
                                             window_bytes))
    return None


def tiled_plan(node_offsets: tuple, data: torch.Tensor, x: torch.Tensor,
               n_in: int, n_sm: int = band_ring.N_SM,
               halo: int = 0) -> TilePlan | None:
    """The tiled route's plan for these tensors, or None where the route
    does not take them: `tile_plan` of their shape, and `data` and `x`
    themselves must start on 16 bytes.  One cache lookup and two address
    checks: this is all a launch decides."""
    n_out, _, nbp = data.shape
    plan = tile_plan(node_offsets, n_out, n_in, nbp, data.element_size(),
                     n_sm, halo)
    if data.data_ptr() % band_ring.COPY_ALIGN \
            or x.data_ptr() % band_ring.COPY_ALIGN:
        return None
    return plan


def plane_route(node_offsets: tuple, data: torch.Tensor, x: torch.Tensor,
                n_in: int, n_sm: int = band_ring.N_SM, halo: int = 0) -> str:
    """Which K1 route `spmv_planes` takes for this operator: 'tiled' where
    `tiled_plan` has a plan (rows and ghost width on 16 bytes, window and
    ring in shared memory), else 'rows'.  Nothing but the shapes and the
    alignment decides."""
    plan = tiled_plan(node_offsets, data, x, n_in, n_sm, halo)
    return "rows" if plan is None else "tiled"


_C_FUNCS = {
    ("rows", torch.float32): "plane_spmv_rows_f32",
    ("rows", torch.float64): "plane_spmv_rows_f64",
    ("tiled", torch.float32): "plane_spmv_tiled_f32",
    ("tiled", torch.float64): "plane_spmv_tiled_f64",
}


@functools.cache
def _kernel_fn(route: str, dtype: torch.dtype):
    """The C entry point of K1's `route` for `dtype`, built and typed on
    first use."""
    lib, _ = cuda_lib.load("plane_dia")
    fn = getattr(lib, _C_FUNCS[route, dtype])
    plan_args = ([ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
                 + [ctypes.c_int] * 4 if route == "tiled" else [])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   *plan_args, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmv_planes_cuda(node_offsets: tuple, data: torch.Tensor,
                     x: torch.Tensor, *, n_in: int, nb: int,
                     route: str | None = None,
                     halo: int = 0) -> torch.Tensor:
    """K1 on the card: one launch on the current stream, no sync.

    `route` None takes `plane_route`'s choice; 'tiled' or 'rows' forces
    one (the comparison of the two on the card) and raises where the
    operator does not fit it.  No route falls back to another."""
    global kernel_launches, halo_launches
    n_out, nbp = _check(node_offsets, data, x, n_in, nb, halo)
    if data.device.type != "cuda":
        raise ValueError(f"K1 needs CUDA tensors, got {data.device}")
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K1 takes float32 or float64, got {data.dtype}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("K1 needs contiguous data and x")
    if route not in (None,) + ROUTES:
        raise ValueError(f"K1 route {route!r}: one of {ROUTES}")
    plan = None
    if route != "rows":
        plan = tiled_plan(node_offsets, data, x, n_in,
                          band_ring.sm_count(x.device), halo)
        if route is None:
            route = "rows" if plan is None else "tiled"
        elif plan is None:
            raise ValueError(
                f"K1's tiled route does not take this operator (nbp={nbp}, "
                f"ghost width {halo}, offsets {min(node_offsets)}.."
                f"{max(node_offsets)}): its rows and ghost width must be "
                "whole 16-byte units and its x window fit "
                f"{band_ring.SMEM_LIMIT} bytes of shared memory")
    plan_args = () if plan is None else (
        len(plan.clusters),
        band_ring.c_int_array(sum(plan.clusters, ())),
        plan.tn, plan.group, plan.stages, plan.grid)
    fn = _kernel_fn(route, data.dtype)
    y = torch.empty((n_out * nbp,), dtype=x.dtype, device=x.device)
    offs = band_ring.c_int_array(node_offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), x.data_ptr(), y.data_ptr(), n_out, n_in,
                len(node_offsets), nb, nbp, halo, offs, *plan_args, stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed ({route}): cudaError {rc}")
    kernel_launches += 1
    route_launches[route] += 1
    form = (f"{n_out}x{n_in}", len(node_offsets), route)
    if halo:
        halo_launches += 1
        form += ("halo",)
    form_launches[form] = form_launches.get(form, 0) + 1
    return y


def spmv_planes(node_offsets: tuple, data: torch.Tensor, x: torch.Tensor, *,
                n_in: int, nb: int, halo: int = 0) -> torch.Tensor:
    """y = A x for an n_out x n_in plane-coupling operator.

    The counterpart of the JAX package's `spmv_planes_pallas`: data
    (n_out, n_in * N_D, nbp), term order `plane_terms(node_offsets, n_in)`,
    x flat plane-major (n_in * nbp,), or (n_in * (nbp + 2 halo),) in the
    ghost-row form, returns (n_out * nbp,).  A CUDA tensor goes through K1,
    by the route `plane_route` names (or raises); a CPU tensor through the
    plain version."""
    if x.device.type == "cpu":
        return spmv_planes_plain(node_offsets, data, x, n_in=n_in, nb=nb,
                                 halo=halo)
    return spmv_planes_cuda(node_offsets, data, x, n_in=n_in, nb=nb,
                            halo=halo)


def spmv_plane(node_offsets: tuple, data: torch.Tensor, x: torch.Tensor, *,
               nb: int, halo: int = 0) -> torch.Tensor:
    """The flagship 4x4 form of `spmv_planes` (`spmv_plane_pallas`)."""
    return spmv_planes(node_offsets, data, x, n_in=4, nb=nb, halo=halo)
