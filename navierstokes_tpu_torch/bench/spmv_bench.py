"""SpMV / matrix-powers benchmark: the port's counterpart of the JAX
package's `bench/spmv_bench.py` (the reference's mpk suite), with the same
flags and the same lines:

    Matrix loaded: <rows> rows, <nnz> nonzeros
    <label> <variant> : <t> us | <speedup>x | rel err = <e> | <MB> (...)

over the synthetic scaling series.  The first variant, the plain PyTorch
DIA SpMV, is the reference (`ref`) the others are held against.  Variants:
up to 200,000 rows the BCSR segment-sum oracle and the block-ELL gather
(`ops/spmv.py`, plain PyTorch as in the JAX package; above, where their
layouts no longer fit the JAX package's budget, one line says they are
skipped); K2 (`csrc/dia.cu`), K2's bfloat16 form on the operator stored
in bf16 (`matvec_dtype`; its rel err is the bf16 rounding of the
operator), K1 on the component-plane layout (`csrc/plane_dia.cu`, timed
in its own layout) and, for spm2v/spm3v/spm4v, the fused one-sweep A^p x,
K4 (`csrc/mpk.cu`).

Usage:
    python -m navierstokes_tpu_torch.bench.spmv_bench --matrices 6 \
        --kernel spm2v,spm3v,spm4v [--dtype float32] [--device cuda] \
        [--disc-cache DIR]

`--disc-cache DIR` keeps one discretization per matrix in DIR/m<id>/,
loaded where it is there and built and saved where it is not.
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np
import torch

from navierstokes_tpu_torch.bench.timing import chained_op_time, rel_error
from navierstokes_tpu_torch.fem.assembly import (
    LINEAR_TERMS,
    assemble_dia_values,
    assemble_operator,
    build_discretization,
    cached_discretization,
)
from navierstokes_tpu_torch.mesh.box import scaling_series_mesh
from navierstokes_tpu_torch.ops import dia as dia_ops
from navierstokes_tpu_torch.ops import mpk_fused
from navierstokes_tpu_torch.ops.mpk import matrix_power
from navierstokes_tpu_torch.ops.plane_dia import (
    extract_planes,
    from_planes,
    node_offsets_from_scalar,
    plane_nbp,
    spmv_plane,
    to_planes,
)
from navierstokes_tpu_torch.ops.spmv import spmv_bcsr_ref, spmv_bell
from navierstokes_tpu_torch.sparse.bell import bell_from_bcsr

KERNELS = {"spmv": ("SpMV", 1), "2spmv": ("2SpMV", 2), "spm2v": ("SpM2V", 2),
           "spm3v": ("SpM3V", 3), "spm4v": ("SpM4V", 4)}
_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# The block-format variants run at sizes where their padded layouts fit,
# as in the JAX package.
BLOCK_ROWS_MAX = 200_000
BLOCK_VARIANTS = ("oracle (segment-sum)", "block-ELL gather")


def _cgs2_hook(V: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """CGS2 projection of y against the 50-vector model basis: the CA-GMRES
    dot-product barrier the reference's 2SpMV benchmark models between its
    chained SpMVs (`mpk/2SpMV.cpp:3-28,109-116`), as torch GEMVs."""
    for _ in range(2):
        y = y - V.T @ (V @ y)
    return y


def block_operands(disc, data: torch.Tensor):
    """(row_ids, indices, BCSR values, ELL indices, ELL values) of the
    operator that `data` holds, assembled on the block pattern, or None
    above `BLOCK_ROWS_MAX` rows."""
    if disc.ndof > BLOCK_ROWS_MAX:
        return None
    dev = data.device
    u0 = torch.zeros(disc.ndof, dtype=data.dtype, device=dev)
    op = assemble_operator(disc, u0, 0.001, 300.0, 0.05, LINEAR_TERMS)
    ell = bell_from_bcsr(op)

    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    return (idx(op.row_ids()), idx(op.indices), op.values, idx(ell.indices),
            ell.values)


def run_one(kernel: str, disc, data: torch.Tensor, *,
            ortho: bool = False, blocks=None) -> list:
    """Time every variant of `kernel` on the assembled operator `data` of
    `disc` (and `blocks`, from `block_operands`, for the block-format
    variants) and print one line each; returns them as dicts (name, us,
    rel_err; rel_err None for the reference)."""
    pat = disc.dia_pattern
    offsets, n, nb = pat.offsets, disc.ndof, disc.nv
    label, k = KERNELS[kernel]
    if ortho:
        label += "+ortho"
    if blocks is None:
        print(f"{label} {', '.join(BLOCK_VARIANTS)} : skipped above "
              f"{BLOCK_ROWS_MAX:,} rows ({n:,})", flush=True)

    noffs = node_offsets_from_scalar(offsets)
    nbp = plane_nbp(nb)
    p4 = extract_planes(offsets, data, nb, node_offsets=noffs, nbp=nbp)
    to_plane_layout = (lambda v: to_planes(v, nb, nbp),
                       lambda v: from_planes(v, nb, nbp))
    # (name, op(offsets, data, v), its offsets and data, applies of op per
    # A^k x, layout converters (to, back) or None)
    variants = [
        ("DIA plain (K2's plain version)", dia_ops.spmv_dia_plain, offsets,
         data, k, None)]
    if blocks is not None:
        row_ids, cols, bcsr_values, ell_idx, ell_values = blocks
        variants += [
            (BLOCK_VARIANTS[0],
             lambda _o, v, x: spmv_bcsr_ref(row_ids, cols, v, x), None,
             bcsr_values, k, None),
            (BLOCK_VARIANTS[1], lambda _o, v, x: spmv_bell(ell_idx, v, x),
             None, ell_values, k, None)]
    variants += [
        ("DIA K2", dia_ops.spmv_dia, offsets, data, k, None),
        ("DIA bf16 K2", dia_ops.spmv_dia, offsets, data.to(torch.bfloat16),
         k, None),
        (f"DIA plane-major K1 (N_D={len(noffs)})",
         functools.partial(spmv_plane, nb=nb), noffs, p4, k, to_plane_layout),
    ]
    if kernel in ("spm2v", "spm3v", "spm4v"):
        plan, _ = mpk_fused.device_plan(n, offsets, data.dtype, data.device)
        passes = mpk_fused.passes_over_a(len(offsets), plan.resident, k)
        variants.append(
            (f"DIA FUSED K4 slab={plan.ld} ({plan.resident}/{len(offsets)} "
             f"diagonals in shared memory, {passes:.2f} passes over A vs "
             f"{k})",
             functools.partial(mpk_fused.spmpv_dia, power=k), offsets, data,
             1, None))

    x = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                        dtype=data.dtype, device=data.device)
    raw = pat.nnz * data.element_size()
    V_nat = None
    if ortho and kernel == "2spmv":
        j = np.arange(n, dtype=np.float64)
        V_nat = torch.as_tensor(
            np.sin(0.001 * j[None, :] + np.arange(50)[:, None]),
            dtype=data.dtype, device=data.device)
    y_ref = t_ref = None
    rows = []
    for name, op, offs, d, applies, layout in variants:
        to_l, post = layout or (lambda v: v, lambda v: v)
        operands = (d,)
        if V_nat is not None:
            Vb = torch.stack([to_l(r) for r in V_nat])

            def fn(v, Vb, d, _op=op, _o=offs, _n=applies):
                y = v
                for i in range(_n):
                    if i:
                        y = _cgs2_hook(Vb, y)
                    y = _op(_o, d, y)
                return y

            operands = (Vb, d)
        else:

            def fn(v, d, _op=op, _o=offs, _n=applies):
                return matrix_power(_o, d, v, _n, spmv=_op)

        mb = sum(o.nbytes for o in operands) / 1e6
        infl = sum(o.nbytes for o in operands) / raw
        xl = to_l(x)
        y = post(fn(xl, *operands)).cpu().numpy()
        t = chained_op_time(fn, xl, operands=operands)
        us = t * 1e6
        if y_ref is None:
            y_ref, t_ref = y, t
            print(f"{label} {name} : {us:8.1f} us | ref | ref | "
                  f"{mb:8.1f} MB ({infl:.2f}x nnz)", flush=True)
            rows.append({"kernel": kernel, "name": name, "us": us,
                         "rel_err": None})
        else:
            err = rel_error(y, y_ref)
            print(f"{label} {name} : {us:8.1f} us | {t_ref / t:.2f}x | "
                  f"rel err = {err:.3e} | {mb:8.1f} MB ({infl:.2f}x nnz)",
                  flush=True)
            rows.append({"kernel": kernel, "name": name, "us": us,
                         "rel_err": err})
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        description="SpMV / matrix-powers benchmark (PyTorch port)")
    p.add_argument("--matrices", default="1,2,3,4,5,6",
                   help="comma-separated matrix ids 1-10")
    p.add_argument("--kernel", default="spmv",
                   help="comma-separated subset of spmv,2spmv,spm2v,spm3v,"
                        "spm4v; the kernels at one size share the "
                        "discretization and the assembled operator")
    p.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    p.add_argument("--ortho", action="store_true",
                   help="2spmv only: insert a CGS2 projection against a "
                        "50-vector model basis between the chained SpMVs "
                        "(mpk/2SpMV.cpp:3-28)")
    p.add_argument("--disc-cache", default=None,
                   help="directory holding per-matrix discretization caches "
                        "(<dir>/m<id>/), created on first use")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu (the kernels' "
                        "plain versions)")
    args = p.parse_args(argv)
    kernels = args.kernel.split(",")
    for kn in kernels:
        if kn not in KERNELS:
            p.error(f"unknown kernel {kn}")
    if args.ortho and kernels != ["2spmv"]:
        p.error("--ortho applies to --kernel 2spmv only")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda but no CUDA device is available "
                "(pass --device cpu to run on the CPU)")
    dtype = _DTYPES[args.dtype]
    rows = []
    for mid in (int(t) for t in args.matrices.split(",")):
        if args.disc_cache:
            disc, _ = cached_discretization(
                os.path.join(args.disc_cache, f"m{mid}"),
                functools.partial(scaling_series_mesh, mid), dtype, device)
        else:
            disc = build_discretization(scaling_series_mesh(mid), dtype,
                                        device)
        pat = disc.dia_pattern
        print(f"Matrix loaded: {disc.ndof} rows, {pat.nnz} nonzeros",
              flush=True)
        data = assemble_dia_values(
            disc.vol, disc.grad, disc.h, 0.001, 300.0, 0.05,
            disc.dia_elem_map, terms=LINEAR_TERMS, K=pat.K, ndof=disc.ndof)
        blocks = block_operands(disc, data)
        for kn in kernels:
            rows += [dict(r, matrix=mid) for r in run_one(
                kn, disc, data, ortho=args.ortho, blocks=blocks)]
    return rows


if __name__ == "__main__":
    main()
