"""Typed configuration, field for field the JAX package's `config.py`.

The dataclasses keep the reference names and defaults so a JAX `NSConfig`
converts one to one (`convert.config_from_jax`).  Dtypes stay strings;
`NSConfig.torch_dtype` maps them to `torch.float32` / `torch.float64`.

The port runs every single-device option of the JAX package: the exact or
the reference Jacobian, the operator or the element-wise residual; the
two-level preconditioner on the component-plane layout ('tlp',
spmv='plane') and on the scalar-DIA layout ('tl'), with the dense, the
multilevel, the linear-basis ('tlp' only) or the smoothed-aggregation
coarse level and the optional Chebyshev smoother; the pressure-Schur block
preconditioner ('sch'); block-Jacobi with its Neumann boost ('bj');
`matvec_dtype='bfloat16'` on 'tl' and 'bj'; GMRES (CGS2 through four GEMVs
or the fused projection K3), CG and CA-GMRES with the monomial or the
Newton basis; and deflation.  `check_supported` raises
`NotImplementedError` only for `ell_slots`, the block-ELL layout of ROADMAP
slice 16.  Distribution is `parallel.DistributedNavierStokesSolver` (the
CLI's `--devices`), which narrows the options further.  It raises the
JAX package's own `ValueError` for what the JAX package refuses, and a
`ValueError` where the JAX package would silently ignore or replace an
option: `preconditioner='ilu0'|'none'` (block-Jacobi there), `matvec_dtype`
off 'tl' and 'bj', and the coarse options under 'bj' and 'sch'.  The
`'auto'` resolution itself is carried over whole, so the tier choice is the
JAX package's; where the tier it chooses cannot take the rest of the
config, `resolve_supported` raises one `ValueError` that says so.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Krylov solver settings (GMRES(30), rtol 1e-10 / atol 1e-12 by default).

    See the JAX package's `SolverConfig` for the measured history of each
    knob; `check_supported` says which are ported.  `spmv`: 'plane' is the
    component-plane layout (two_level only; a scalar operator treats it as
    'auto'); 'auto' and 'pallas' run kernel K2 on the card for every
    scalar-DIA operator; 'xla' runs K2's plain PyTorch version, kernel-free,
    for debugging."""

    method: str = "gmres"
    restart: int = 30
    rtol: float = 1e-10
    atol: float = 1e-12
    maxiter: int = 2000
    preconditioner: str = "block_jacobi"
    neumann_order: int = 2
    coarse_agg: Optional[int] = None      # None = auto_coarse_agg schedule
    coarse_shift: float = 1e-6            # diagonal shift on A_c
    coarse_ml_smooth: int = 1
    coarse_ml_cycles: int = 1
    coarse_ml_damp: float = 1.0
    coarse_basis: str = "const"
    coarse_smooth_omega: float = 0.0
    coarse_cheby: int = 0                 # Chebyshev post-smoother degree
    coarse_cheby_fraction: float = 0.3    # interval [f*lmax, 1.05*lmax]
    schur_cheby: int = 2
    schur_v_cheby: int = 0
    schur_shape: str = "lower"
    coarse_dense_max: int = 4096          # max nc for the dense inverse
    spmv: str = "auto"
    deflation_k: int = 0
    deflation_arnoldi: int = 0
    cgs2: str = "xla"
    ca_basis: str = "monomial"
    matvec_dtype: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Newton iteration controls (`src/solve_newton.c:936-940`)."""

    rtol: float = 1e-6
    atol: float = 1e-8
    stol: float = 1e-10
    max_iter: int = 30
    du_tol: Optional[float] = None   # None = atol (reference semantics)


@dataclasses.dataclass(frozen=True)
class NSConfig:
    """Full problem description; defaults follow the golden-corpus run."""

    dt: float = 1e-3
    t_final: float = 1.0
    reynolds: float = 300.0
    delta: float = 0.05
    stokes_reynolds: float = 0.01

    newton: NewtonConfig = dataclasses.field(default_factory=NewtonConfig)
    krylov: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    stokes_krylov: SolverConfig = dataclasses.field(
        default_factory=lambda: SolverConfig(rtol=1e-12, atol=1e-12,
                                             maxiter=1000)
    )

    dtype: str = "float32"
    assembly_dtype: str = "float64"
    residual: str = "operator"
    jacobian: str = "exact"
    ell_slots: Optional[int] = None
    save_every: int = 0
    output_dir: str = "res"

    @property
    def n_steps(self) -> int:
        return int(round(self.t_final / self.dt))

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def auto_coarse_agg(ndof: int) -> int:
    """Measured two_level aggregate-size schedule (swept values)."""
    if ndof <= 150_000:
        return 48
    if ndof <= 600_000:
        return 128
    return 256


AUTO_COARSE_DENSE_CAP = 16_384


def auto_preconditioner(ndof: int) -> dict:
    """Measured preconditioner schedule: two_level + Chebyshev 3 up to 150k
    rows, the pressure-Schur block preconditioner above."""
    if ndof <= 150_000:
        return {"preconditioner": "two_level", "coarse_cheby": 3}
    return {"preconditioner": "schur", "schur_v_cheby": 2}


def resolve_coarse_defaults(cfg: NSConfig, nv: int,
                            single_chip: bool = True) -> NSConfig:
    """Resolve preconditioner='auto' and coarse_agg=None to the measured
    size schedules, exactly as the JAX package does."""

    def fix_precond(sc: SolverConfig) -> SolverConfig:
        if sc.preconditioner != "auto":
            return sc
        upd = dict(auto_preconditioner(4 * nv))
        if cfg.jacobian != "exact":
            upd = {"preconditioner": "two_level"}
        elif upd["preconditioner"] == "schur" and (
                not single_chip or sc.spmv != "plane" or sc.deflation_k):
            upd = {"preconditioner": "two_level"}
        elif not single_chip:
            upd = {"preconditioner": "two_level"}
        for knob in ("coarse_cheby", "schur_v_cheby"):
            if getattr(sc, knob) and knob in upd:
                del upd[knob]
        return dataclasses.replace(sc, **upd)

    def fix(sc: SolverConfig) -> SolverConfig:
        sc = fix_precond(sc)
        if sc.coarse_agg is not None:
            return sc
        agg = auto_coarse_agg(4 * nv)
        updates = {"coarse_agg": agg}
        nc = 4 * (-(-nv // agg))
        if sc.coarse_basis == "const" and \
                sc.coarse_dense_max < nc <= AUTO_COARSE_DENSE_CAP:
            updates["coarse_dense_max"] = nc
        return dataclasses.replace(sc, **updates)

    return dataclasses.replace(
        cfg, krylov=fix(cfg.krylov), stokes_krylov=fix(cfg.stokes_krylov)
    )


SPMV_CHOICES = ("auto", "xla", "pallas", "plane")
CGS2_CHOICES = ("xla", "pallas", "pallas_comp")


def second_level_agg(nc: int, coarse_dense_max: int) -> int:
    """Aggregate size of the multilevel path's second level, in coarse
    nodes: ceil(nc / coarse_dense_max), at least 2."""
    return max(-(-nc // coarse_dense_max), 2)


METHODS = ("gmres", "cg", "ca_gmres")
CA_BASES = ("monomial", "newton")


def _check_method(sc: SolverConfig) -> None:
    if sc.method not in METHODS:
        raise ValueError(f"unknown method {sc.method!r}; one of {METHODS}")
    if sc.cgs2 not in CGS2_CHOICES:
        raise ValueError(f"unknown cgs2 backend {sc.cgs2!r}; expected "
                         "'xla', 'pallas' or 'pallas_comp'")
    if sc.ca_basis not in CA_BASES:
        raise ValueError(f"unknown ca_basis {sc.ca_basis!r}; expected "
                         "'monomial' or 'newton'")


def _check_schur(sc: SolverConfig, jacobian: str) -> None:
    """The JAX model's validation of preconditioner='schur'."""
    if sc.spmv != "plane":
        raise ValueError("preconditioner='schur' requires spmv='plane' (the "
                         "sub-block applies run on the component-plane "
                         "layout)")
    if jacobian != "exact":
        raise ValueError("preconditioner='schur' requires jacobian='exact': "
                         "the Schur complement and coarse inverses are "
                         "built on the host at operator preparation")
    if sc.schur_shape not in ("lower", "full"):
        raise ValueError(f"unknown schur_shape {sc.schur_shape!r}; expected "
                         "'lower' or 'full'")
    if sc.deflation_k:
        raise ValueError("deflation_k is not supported with preconditioner="
                         "'schur' (recycling is built on the two-level "
                         "preps)")


def _layout(sc: SolverConfig) -> str:
    """The prep kind a resolved SolverConfig builds."""
    if sc.preconditioner == "block_jacobi":
        return "bj"
    if sc.preconditioner == "schur":
        return "sch"
    return "tlp" if sc.spmv == "plane" else "tl"


MATVEC_DTYPES = (None, "bfloat16")


def _check_matvec_dtype(sc: SolverConfig) -> None:
    """matvec_dtype='bfloat16' stores the operator GMRES applies in bf16;
    the JAX package casts it on the scalar-DIA preps only, 'tl' and 'bj'.
    Its 'tlp' and 'sch' preps return before the cast and ignore the option
    (so 'auto', which resolves to one of them at every size, ignores it
    too): the port raises there instead."""
    if sc.matvec_dtype not in MATVEC_DTYPES:
        raise ValueError(f"unknown matvec_dtype {sc.matvec_dtype!r}; "
                         f"one of {MATVEC_DTYPES}")
    if sc.matvec_dtype is None:
        return
    kind = _layout(sc)
    if kind in ("tlp", "sch"):
        raise ValueError(
            f"matvec_dtype={sc.matvec_dtype!r} takes the scalar-DIA layouts "
            "only: preconditioner='two_level' with spmv auto, xla or pallas "
            "('tl'), or preconditioner='block_jacobi' ('bj'); this config "
            f"resolved to preconditioner={sc.preconditioner!r}, "
            f"spmv={sc.spmv!r} ('{kind}'), which would ignore it")


def _check_coarse_variants(sc: SolverConfig, nv: int, jacobian: str) -> None:
    """coarse_basis='linear' and coarse_smooth_omega, as the JAX model
    validates them in `_prepare_operator_dia`; under 'bj' and 'sch', where
    the JAX package ignores both, the port raises."""
    if sc.coarse_basis not in ("const", "linear"):
        raise ValueError(f"unknown coarse_basis {sc.coarse_basis!r}; "
                         "expected 'const' or 'linear'")
    linear = sc.coarse_basis == "linear"
    if not (linear or sc.coarse_smooth_omega):
        return
    knob = "coarse_basis='linear'" if linear else \
        f"coarse_smooth_omega={sc.coarse_smooth_omega}"
    kind = _layout(sc)
    if kind in ("bj", "sch"):
        raise ValueError(
            f"{knob} takes the two-level coarse level only "
            "(preconditioner='two_level'); this config resolved to "
            f"preconditioner={sc.preconditioner!r} ('{kind}'), which would "
            "ignore it")
    n_agg = -(-nv // sc.coarse_agg)
    if linear:
        if kind != "tlp":
            raise ValueError("coarse_basis='linear' requires spmv='plane' "
                             "(the single-chip component-plane path)")
        if sc.coarse_smooth_omega:
            raise ValueError("coarse_basis='linear' and coarse_smooth_omega "
                             "are mutually exclusive")
        if 16 * n_agg > sc.coarse_dense_max:
            raise ValueError(
                "coarse_basis='linear' is supported on the dense coarse path "
                f"only (nc={16 * n_agg} > coarse_dense_max="
                f"{sc.coarse_dense_max}); raise coarse_agg or "
                "coarse_dense_max")
        if jacobian != "exact":
            raise ValueError(
                "coarse_basis='linear' requires eager operator preparation "
                "(the default exact-Jacobian flow): the Galerkin product and "
                "its inverse are built on the host in f64")
        return
    if 4 * n_agg > sc.coarse_dense_max:
        raise ValueError(
            "coarse_smooth_omega is supported on the dense coarse path only "
            f"(nc={4 * n_agg} > coarse_dense_max={sc.coarse_dense_max}); "
            "raise coarse_dense_max or coarse_agg")
    if jacobian != "exact":
        raise ValueError(
            "coarse_smooth_omega requires eager operator preparation "
            "(jacobian='exact'); the traced (reference-jacobian) path "
            "cannot build the smoothed Galerkin product on host")


def _check_krylov(sc: SolverConfig, nv: int, jacobian: str) -> None:
    _check_method(sc)
    p = sc.preconditioner
    if p in ("ilu0", "none"):
        raise ValueError(
            f"preconditioner={p!r}: the JAX package runs block-Jacobi under "
            "this name (its model prepares 'schur', 'two_level' and "
            "otherwise 'bj'), and its ILU(0) is a host oracle "
            "(solvers/precond.py, here too); set preconditioner="
            "'block_jacobi' for what the JAX package runs")
    if p not in ("two_level", "block_jacobi", "schur"):
        raise ValueError(f"unknown preconditioner {p!r}")
    if sc.spmv not in SPMV_CHOICES:
        raise ValueError(f"unknown spmv {sc.spmv!r}; one of {SPMV_CHOICES}")
    _check_coarse_variants(sc, nv, jacobian)
    _check_matvec_dtype(sc)
    if sc.coarse_cheby:
        if p != "two_level":
            raise ValueError("coarse_cheby is the two_level post-smoother; "
                             "set preconditioner='two_level' (or "
                             "coarse_cheby=0)")
        if not 0.0 < sc.coarse_cheby_fraction < 1.0:
            raise ValueError("coarse_cheby_fraction must be in (0, 1), got "
                             f"{sc.coarse_cheby_fraction}")
        if jacobian != "exact":
            raise ValueError(
                "coarse_cheby requires eager operator preparation "
                "(jacobian='exact'): the interval estimate is a host-side "
                "eigenvalue computation")
    if sc.deflation_k:
        if jacobian != "exact":
            raise ValueError(
                "deflation_k requires jacobian='exact' (recycling assumes a "
                "constant operator; the 'reference' mode rebuilds it every "
                "Newton iteration)")
        if sc.method != "gmres":
            raise ValueError("deflation_k requires method='gmres' (the "
                             "projected solve wraps the standard restarted "
                             "GMRES)")
    if sc.method == "ca_gmres" and sc.ca_basis == "newton" \
            and jacobian != "exact":
        raise ValueError("ca_basis='newton' requires jacobian='exact' (the "
                         "shifts are Ritz values of the constant prepared "
                         "operator)")
    n_agg = -(-nv // sc.coarse_agg)
    if p == "schur" and 3 * n_agg > sc.coarse_dense_max:
        raise ValueError("preconditioner='schur' uses dense coarse inverses "
                         f"(velocity nc={3 * n_agg} > coarse_dense_max="
                         f"{sc.coarse_dense_max}); raise coarse_agg or "
                         "coarse_dense_max")
    if p == "two_level" and 4 * n_agg > sc.coarse_dense_max:
        nc2 = 4 * -(-n_agg // second_level_agg(4 * n_agg,
                                               sc.coarse_dense_max))
        if nc2 > sc.coarse_dense_max:
            raise ValueError(f"second coarse level still too large (nc2={nc2}"
                             f" > {sc.coarse_dense_max}); raise coarse_agg "
                             "or coarse_dense_max")


def check_supported(cfg: NSConfig, nv: int) -> None:
    """Validate a RESOLVED config (see the module docstring).

    As in the JAX package, both the Stokes and the Newton operators are
    prepared from `cfg.krylov`; `cfg.stokes_krylov` only sets the Stokes
    solve's method and tolerances.  Every `residual` other than
    'operator' means the element-wise residual, as in the JAX package."""
    if cfg.ell_slots is not None:
        raise NotImplementedError(
            "ell_slots (the block-ELL layout) is not ported to "
            "navierstokes_tpu_torch yet (ROADMAP slice 16: the rest)")
    if cfg.krylov.preconditioner == "schur":
        _check_schur(cfg.krylov, cfg.jacobian)
    if cfg.jacobian not in ("exact", "reference"):
        raise ValueError(f"unknown jacobian {cfg.jacobian!r}")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    _check_krylov(cfg.krylov, nv, cfg.jacobian)
    _check_method(cfg.stokes_krylov)


def _check_auto_tier(user: SolverConfig, resolved: SolverConfig,
                     nv: int) -> None:
    """Where 'auto' chose the Schur tier, the knobs the user pinned must
    fit it: raise one ValueError that names the knob and the tier."""
    if user.preconditioner != "auto" or resolved.preconditioner != "schur":
        return
    tier = (f"preconditioner='auto' chose the Schur tier at {4 * nv} rows "
            "(above 150,000)")
    if user.coarse_cheby:
        raise ValueError(
            f"{tier}, but coarse_cheby={user.coarse_cheby} is pinned: "
            "coarse_cheby is the two_level post-smoother, which the Schur "
            "tier does not run; drop coarse_cheby (the tier's smoothers are "
            "schur_cheby and schur_v_cheby) or set preconditioner="
            "'two_level'")
    n_agg = -(-nv // resolved.coarse_agg)
    if 3 * n_agg > resolved.coarse_dense_max:
        raise ValueError(
            f"{tier}, whose dense velocity coarse inverse needs nc="
            f"{3 * n_agg} > coarse_dense_max={resolved.coarse_dense_max}: "
            "'auto' raises coarse_dense_max only up to "
            f"AUTO_COARSE_DENSE_CAP={AUTO_COARSE_DENSE_CAP}; set "
            "preconditioner='two_level' (its multilevel coarse level takes "
            "this size), or a larger coarse_agg or coarse_dense_max")


def _warn_auto_degraded(cfg: NSConfig, resolved: NSConfig, nv: int) -> None:
    """Under distribution 'auto' resolves to plain two_level: say so, once,
    where one device would have taken another tier (the JAX package
    degrades silently)."""
    single = resolve_coarse_defaults(cfg, nv)
    for user, dist, one in ((cfg.krylov, resolved.krylov, single.krylov),
                            (cfg.stokes_krylov, resolved.stokes_krylov,
                             single.stokes_krylov)):
        if user.preconditioner != "auto" or dist == one:
            continue
        warnings.warn(
            f"preconditioner='auto' resolves to plain two_level under "
            f"distribution (coarse_cheby={dist.coarse_cheby}); one device "
            f"would take preconditioner={one.preconditioner!r} with "
            f"coarse_cheby={one.coarse_cheby}, schur_v_cheby="
            f"{one.schur_v_cheby} at {4 * nv} rows", stacklevel=3)
        return


def resolve_supported(cfg: NSConfig, nv: int,
                      single_chip: bool = True) -> NSConfig:
    """`resolve_coarse_defaults` (for one device, or with `single_chip`
    False for the distributed solver, which warns where 'auto' degrades),
    then `check_supported`."""
    resolved = resolve_coarse_defaults(cfg, nv, single_chip=single_chip)
    if not single_chip:
        _warn_auto_degraded(cfg, resolved, nv)
    _check_auto_tier(cfg.krylov, resolved.krylov, nv)
    check_supported(resolved, nv)
    return resolved
