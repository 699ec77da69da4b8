"""K1's share of its roofline for one form (n_out x n_in), from the kernel
names of a device trace and the program's launch counter.

The tiled route compiles one kernel per form,
`plane_spmv_tiled_kernel<T, NOUT, NIN, kGroup>` (`csrc/plane_dia.cu`), so
its name in the trace gives the form.  The rows route's,
`plane_spmv_rows_kernel<T, NOUT, kGhost>`, gives no NIN: where a launch of
an n_out x N form took that route, the form's time cannot be told apart
and there is nothing to read.
"""

from __future__ import annotations

import re

from benchmark.kernels import k1_bytes, peak

TILED = re.compile(r"plane_spmv_tiled_kernel<\s*\w+\s*,\s*(?:\(int\))?(\d+)"
                   r"\s*,\s*(?:\(int\))?(\d+)\s*,")


def tiled_form(name: str):
    """(n_out, n_in) of a tiled K1 kernel's name, else None."""
    m = TILED.search(name)
    return (int(m.group(1)), int(m.group(2))) if m else None


def roofline_pct(r, n_out: int, n_in: int):
    """The form's least time (its launches in the traced segments times its
    least bytes, `kernels.k1_bytes`, over the card's HBM bandwidth) over
    the device time of its tiled kernels there.  None where the run holds
    no such launch or kernel, on a card `peaks.json` does not hold, where a
    ghost-row launch ran, or where an n_out x N launch took the rows
    route."""
    bandwidth = peak(r.device["kind"], "hbm_bytes_per_s")
    if not r.trace or not r.k1_forms or bandwidth is None:
        return None
    launched = {k: n for k, n in r.k1_forms.items() if n}
    if any(halo or (out == n_out and route == "rows")
           for (out, _, _, route, halo) in launched):
        return None
    us = sum(d for name, d in r.trace["kernels"]
             if tiled_form(name) == (n_out, n_in))
    least = sum(n * k1_bytes(n_out, n_in, n_offsets, r.nbp, r.itemsize)
                for (out, nin, n_offsets, _, _), n in launched.items()
                if (out, nin) == (n_out, n_in))
    if not us or not least:
        return None
    return 100.0 * (least / bandwidth) / (us * 1e-6)
