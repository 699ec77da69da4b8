"""K1's least time over its device time in the traced segments.  Least
time: over K1's forms, launches (the program's form_launches counter, in
the traced segments) times the form's least bytes (`kernels.k1_bytes`,
nbp by the frozen padding rule) over the card's HBM bandwidth
(`peaks.json`).  Nothing on a card the table does not hold, or where a
launch of the ghost-row form (whose width the counter does not give) ran.
"""

from benchmark.kernels import K1_KERNEL, k1_bytes, peak

UNIT, SOURCE = "%", "device_trace"
LAYER = "kernel K1 (ops/plane_dia.py, csrc/plane_dia.cu)"
MOVES = "step_ms_p95"


def read(r):
    bandwidth = peak(r.device["kind"], "hbm_bytes_per_s")
    if not r.trace or not r.k1_forms or bandwidth is None:
        return None
    if any(halo for (_, _, _, _, halo) in r.k1_forms):
        return None
    us = sum(d for name, d in r.trace["kernels"] if K1_KERNEL in name)
    if not us:
        return None
    least = sum(n * k1_bytes(n_out, n_in, n_offsets, r.nbp, r.itemsize)
                for (n_out, n_in, n_offsets, _, _), n in r.k1_forms.items())
    return 100.0 * (least / bandwidth) / (us * 1e-6)
