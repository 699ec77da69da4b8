"""What Python decides for the tiled route of kernel K1.

The route streams a banded operator through a ring of shared-memory stages
(`csrc/band_ring.cuh`).  The wrapper chooses the row tile and the depth of
the ring here, in code the CPU tests reach; the kernel takes the plan as
arguments and checks it again.  The constants mirror the header's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

N_SM = 132              # SMs of the H100: the default of the tile plans
SMEM_LIMIT = 232_448    # kSmemLimit: dynamic shared memory of one block
HEADER_BYTES = 256      # kHeaderBytes: the mbarriers, ahead of the ring
MAX_STAGES = 8          # kMaxStages
MIN_STAGES = 2          # fewer leaves nothing in flight while a stage is used
COPY_ALIGN = 16         # bytes: source, destination and size of a bulk copy
WARP = 32


def wave_tile(n: int, n_sm: int, max_tile: int) -> int:
    """Rows per tile so that the tiles of `n` rows fill `n_sm` blocks in
    whole waves: the smallest number of waves whose tile is at most
    `max_tile`, the tile rounded up to whole warps."""
    per_sm = -(-n // n_sm)
    waves = -(-per_sm // max_tile)
    tile = -(-n // (n_sm * waves))
    return max(WARP, -(-tile // WARP) * WARP)


def ring_stages(slot_bytes: int, window_bytes: int) -> int:
    """The deepest ring, up to MAX_STAGES, that fits shared memory beside
    the x window; 0 where fewer than MIN_STAGES fit."""
    room = SMEM_LIMIT - HEADER_BYTES - window_bytes
    stages = min(MAX_STAGES, room // slot_bytes) if room > 0 else 0
    return stages if stages >= MIN_STAGES else 0


def smem_bytes(stages: int, slot_bytes: int, window_bytes: int) -> int:
    """Dynamic shared memory of one block: header, ring, x windows."""
    return HEADER_BYTES + stages * slot_bytes + window_bytes


def window_values(tn: int, offsets: tuple, itemsize: int) -> int:
    """Values in a tile's x window: the tile's rows and the band on either
    side, the smallest offset rounded down and the largest up to whole
    16-byte units, so that the window is one aligned bulk copy."""
    unit = COPY_ALIGN // itemsize
    lo = min(offsets) // unit * unit
    hi = -(-max(offsets) // unit) * unit
    return tn + hi - lo


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
