"""What Python decides for the tiled route of kernel K1.

The route streams a banded operator through a ring of shared-memory stages
(`csrc/band_ring.cuh`).  The wrapper chooses the row tile, the node
offsets per stage and the depth of the ring here, in code the CPU tests
reach; the kernel takes the plan, the x window's clusters included, as
arguments and checks it again.  The constants mirror the header's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

N_SM = 132              # SMs of the H100: the default of the tile plans
SMEM_LIMIT = 232_448    # kSmemLimit: dynamic shared memory of one block
HEADER_BYTES = 512      # kHeaderBytes: mbarriers, window layout; ring follows
MAX_STAGES = 8          # kMaxStages
MAX_CLUSTERS = 8        # kMaxClusters: x window segments of a tile
SLOT_BYTES = 16 * 1024  # what a stage aims at: enough bytes per round trip
MIN_STAGES = 2          # fewer leaves nothing in flight while a stage is used
COPY_ALIGN = 16         # bytes: source, destination and size of a bulk copy
MAX_BOX = 256           # kMaxBox: a tensor copy's box, values per dimension
BOX_ALIGN = 128         # kBoxAlign: bytes, a tensor copy's destination
TENSOR_ROW_BYTES = 512  # a tile's row segments up to this: tensor copies
WARP = 32


def wave_tile(n: int, n_sm: int, max_tile: int) -> int:
    """Rows per tile so that the tiles of `n` rows fill `n_sm` blocks in
    whole waves: the tile of the fewest waves that is at most `max_tile`,
    rounded up to whole warps, or of one or two waves more where that
    leaves the busiest block fewer rows (the rounding can cost a wave its
    last tiles: 587,264 rows on 132 SMs take 9 waves of 512 rows, 4,608 a
    block, or 10 of 448, 4,480)."""
    per_sm = -(-n // n_sm)
    fewest = -(-per_sm // max_tile)
    best = None
    for waves in range(fewest, fewest + 3):
        tile = -(-n // (n_sm * waves))
        tile = max(WARP, -(-tile // WARP) * WARP)
        rounds = -(-(-(-n // tile)) // n_sm)     # tiles of the busiest block
        busiest = rounds * tile
        if tile <= max_tile and (best is None or busiest < best[0]):
            best = (busiest, tile)
    return best[1]


def tensor_copies(tn: int, itemsize: int) -> bool:
    """Whether a plan's stages come by tensor copies, one per node offset
    (the box of its n_out * n_in row segments), and not by one bulk copy
    per row segment: where a row segment of the tile is at most
    TENSOR_ROW_BYTES.  Measured in turns on an H100 (PERF.md §6): a
    matrix-6 shard's 4x4 and 3x3 tiles of 64 and 32 rows (segments of 128
    to 512 bytes) take 6-33% less time flushed by tensor copies, because
    the copy engine spends about as long on a short copy as on a long one;
    the whole-vector forms' tiles of 224-512 rows (896 bytes and more) take
    up to 7% more, and the 1x1 forms, whose offset is one segment, gain
    nothing from a box."""
    return tn * itemsize <= TENSOR_ROW_BYTES


def stage_tx_bytes(offsets: int, tn: int, i0: int, nbp: int, n_out: int,
                   n_in: int, itemsize: int, tensor: bool) -> int:
    """The bytes a stage of `offsets` node offsets announces on its full
    barrier for the tile at row i0: a bulk copy brings each segment's rows
    up to nbp, a tensor copy its whole box, whose rows past nbp land as
    zeros and count."""
    rows = tn if tensor else min(tn, nbp - i0)
    return offsets * n_out * n_in * rows * itemsize


def box_checks(tn: int, n_out: int, n_in: int, nbp: int, group: int,
               stages: int, itemsize: int) -> list:
    """What the kernel's tensor copies rely on that a tile plan must give,
    as a list of the failures (empty where all hold): every box dimension
    at most MAX_BOX; the box's rows and the operator's row stride whole
    16-byte units; every box of every slot landing on BOX_ALIGN bytes
    after the header.  A box, innermost first, is (tn, n_in, n_out) of the
    operator seen as the 3-D tensor (nbp, n_in * N_D, n_out): one node
    offset's row segments."""
    failed = []
    dims = (tn, n_in, n_out)
    if max(dims) > MAX_BOX:
        failed.append(f"box {dims} over {MAX_BOX}")
    if (tn * itemsize) % COPY_ALIGN or (nbp * itemsize) % COPY_ALIGN:
        failed.append("box rows or row stride not whole 16-byte units")
    box = n_out * n_in * tn * itemsize
    for at in (HEADER_BYTES + (s * group + k) * box
               for s in range(stages) for k in range(group)):
        if at % BOX_ALIGN:
            failed.append(f"box at byte {at}")
    return failed


def ring_stages(slot_bytes: int, window_bytes: int) -> int:
    """The deepest ring, up to MAX_STAGES, that fits shared memory beside
    the x window; 0 where fewer than MIN_STAGES fit."""
    room = SMEM_LIMIT - HEADER_BYTES - window_bytes
    stages = min(MAX_STAGES, room // slot_bytes) if room > 0 else 0
    return stages if stages >= MIN_STAGES else 0


def smem_bytes(stages: int, slot_bytes: int, window_bytes: int) -> int:
    """Dynamic shared memory of one block: header, ring, x windows."""
    return HEADER_BYTES + stages * slot_bytes + window_bytes


def stage_group(offset_bytes: int, n_offsets: int, room: int) -> int:
    """Node offsets per stage: as many as make a stage of about SLOT_BYTES
    (`offset_bytes`: one offset's segments), at least 1, at most all of
    them, and no more than leave MIN_STAGES stages inside `room` bytes; 0
    where one offset is already too large for that."""
    fit = room // (MIN_STAGES * offset_bytes) if room > 0 else 0
    return min(max(1, SLOT_BYTES // offset_bytes), n_offsets, fit)


def window_clusters(offsets: tuple, split: int, itemsize: int) -> tuple:
    """The x window's segments: ((lo, hi), ...), one per cluster of the
    sorted offsets, split at the gaps between neighbours that exceed
    `split` (the plan's is the tile's rows: a segment of its own costs the
    tile's rows again, one contiguous segment the gap), the widest
    MAX_CLUSTERS - 1 of them where there are more (the first of equal
    gaps first).  lo is the cluster's smallest offset rounded down, hi its
    largest rounded up, to whole 16-byte units, so that the segment of a
    tile of tn rows, x[i0 + lo .. i0 + tn + hi), is an aligned bulk copy."""
    unit = COPY_ALIGN // itemsize
    s = sorted(offsets)
    gaps = sorted((-(s[k + 1] - s[k]), k) for k in range(len(s) - 1)
                  if s[k + 1] - s[k] > split)
    cuts = sorted(k for _, k in gaps[:MAX_CLUSTERS - 1])
    firsts = [0] + [k + 1 for k in cuts]
    lasts = cuts + [len(s) - 1]
    return tuple((s[a] // unit * unit, -(-s[b] // unit) * unit)
                 for a, b in zip(firsts, lasts))


def window_values(tn: int, clusters: tuple) -> int:
    """Values of one plane of a tile's x window: each segment is the tile's
    rows and its cluster's span."""
    return sum(tn + hi - lo for lo, hi in clusters)


def window_buffers(n_tiles: int, grid: int) -> int:
    """x window buffers of a launch: two where a block walks more than one
    tile, so that the next tile's window loads while this one's is read."""
    return 2 if n_tiles > grid else 1


@functools.cache
def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (asked once: the wrappers run per launch)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def c_int_array(values: tuple):
    """`values` as a C int array for a kernel's offsets argument."""
    return (ctypes.c_int * len(values))(*values)
