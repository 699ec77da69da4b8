"""Typed configuration, field for field the JAX package's `config.py`.

The dataclasses keep the reference names and defaults so a JAX `NSConfig`
converts one to one (`convert.config_from_jax`).  Dtypes stay strings;
`NSConfig.torch_dtype` maps them to `torch.float32` / `torch.float64`.

The port runs these slices of the JAX package, all with the exact Jacobian
and the operator-form residual: the two-level preconditioner on the
component-plane layout ('tlp', spmv='plane') and on the scalar-DIA layout
('tl', spmv in auto/xla/pallas), the pressure-Schur block preconditioner
on the plane layout ('sch', the f32 'auto' tier above 150k rows),
block-Jacobi with its Neumann boost ('bj', the float64 default), and for
both two-level layouts the dense or the multilevel coarse level; GMRES
orthogonalizes with four GEMVs (cgs2='xla') or the fused projection K3
('pallas', 'pallas_comp' with compensated sums).  `check_supported`
raises `NotImplementedError` for every option outside them, naming the
ROADMAP slice that ports it, so that no option silently runs something
else.  The `'auto'` resolution itself is carried over whole, so the tier
choice is the JAX package's; where the tier it chooses cannot take the
rest of the config, `resolve_supported` raises one `ValueError` that says
so.
"""

from __future__ import annotations

import dataclasses
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


def _not_ported(what: str, slice_no: int, title: str):
    raise NotImplementedError(
        f"{what} is not ported to navierstokes_tpu_torch yet "
        f"(ROADMAP slice {slice_no}: {title})"
    )


def _check_method(sc: SolverConfig) -> None:
    if sc.method == "ca_gmres":
        _not_ported("method='ca_gmres'", 12, "CA-GMRES")
    if sc.method == "cg":
        _not_ported("method='cg'", 11, "other preconditioners and solvers")
    if sc.method != "gmres":
        raise ValueError(f"unknown method {sc.method!r}")
    if sc.cgs2 not in CGS2_CHOICES:
        raise ValueError(f"unknown cgs2 backend {sc.cgs2!r}; expected "
                         "'xla', 'pallas' or 'pallas_comp'")


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


def _check_krylov(sc: SolverConfig, nv: int) -> None:
    _check_method(sc)
    p = sc.preconditioner
    if p in ("ilu0", "none"):
        _not_ported(f"preconditioner={p!r}", 11,
                    "other preconditioners and solvers")
    if p not in ("two_level", "block_jacobi", "schur"):
        raise ValueError(f"unknown preconditioner {p!r}")
    if sc.spmv not in SPMV_CHOICES:
        raise ValueError(f"unknown spmv {sc.spmv!r}; one of {SPMV_CHOICES}")
    if sc.deflation_k:
        _not_ported("deflation_k", 13, "deflation")
    if sc.deflation_arnoldi:
        _not_ported("deflation_arnoldi", 13, "deflation")
    if sc.coarse_basis == "linear":
        _not_ported("coarse_basis='linear'", 10, "the coarse variants")
    if sc.coarse_basis != "const":
        raise ValueError(f"unknown coarse_basis {sc.coarse_basis!r}; "
                         "expected 'const' or 'linear'")
    if sc.coarse_smooth_omega:
        _not_ported("coarse_smooth_omega", 10, "the coarse variants")
    if sc.matvec_dtype is not None:
        _not_ported("matvec_dtype", 3, "the plane layout and K1")
    if sc.coarse_cheby:
        if p != "two_level":
            raise ValueError("coarse_cheby is the two_level post-smoother; "
                             "set preconditioner='two_level' (or "
                             "coarse_cheby=0)")
        if not 0.0 < sc.coarse_cheby_fraction < 1.0:
            raise ValueError("coarse_cheby_fraction must be in (0, 1), got "
                             f"{sc.coarse_cheby_fraction}")
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
    """Raise NotImplementedError for any option of a RESOLVED config that
    lies outside the ported slice (see the module docstring).

    As in the JAX package, both the Stokes and the Newton operators are
    prepared from `cfg.krylov`; `cfg.stokes_krylov` only sets the Stokes
    solve's method and tolerances."""
    if cfg.krylov.preconditioner == "schur":
        _check_schur(cfg.krylov, cfg.jacobian)
    if cfg.jacobian == "reference":
        _not_ported("jacobian='reference'", 5, "the model main path")
    if cfg.jacobian != "exact":
        raise ValueError(f"unknown jacobian {cfg.jacobian!r}")
    if cfg.residual != "operator":
        _not_ported(f"residual={cfg.residual!r}", 2, "assembly")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    _check_krylov(cfg.krylov, nv)
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


def resolve_supported(cfg: NSConfig, nv: int) -> NSConfig:
    """`resolve_coarse_defaults` for one device, then `check_supported`."""
    resolved = resolve_coarse_defaults(cfg, nv)
    _check_auto_tier(cfg.krylov, resolved.krylov, nv)
    check_supported(resolved, nv)
    return resolved
