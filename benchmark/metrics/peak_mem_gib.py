"""torch.cuda.max_memory_allocated() over set-up and the window, GiB."""

UNIT, LAYER, MOVES, SOURCE = "GiB", None, None, "host_clock"


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes else None
