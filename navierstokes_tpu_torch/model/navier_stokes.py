"""The transient Navier–Stokes engine: Stokes initialization, then
backward-Euler steps with Newton on the exact Jacobian.

Pipeline per run (the reference's `src/solve_newton.c:925-1323`):
  1. Stokes initialization: assemble the steady Stokes operator with the
     small Stokes Reynolds number, apply Dirichlet rows, GMRES-solve.
  2. Time loop: per Newton iteration insert BC values, evaluate the
     residual F = A_lin u - (M/dt) u_old (two plane SpMVs), test
     convergence, solve J du = -F with GMRES on the constant, once-prepared
     exact Jacobian.

The ported slice is the flagship single-device path of the JAX package's
`model/navier_stokes.py`: the operator in component-plane layout (kernel K1,
`ops/plane_dia.py`), the two-level preconditioner with a dense coarse
inverse and a Jacobi or Chebyshev post-smoother, GMRES with CGS2.  Newton
and GMRES are Python loops over device tensors; the host reads only the
norms and Hessenberg columns it branches on.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from navierstokes_tpu_torch.config import NSConfig, resolve_supported
from navierstokes_tpu_torch.fem.assembly import (
    LINEAR_TERMS,
    STOKES_TERMS,
    Discretization,
    assemble_dia_values,
    build_discretization,
)
from navierstokes_tpu_torch.io.dat import write_petsc_vec
from navierstokes_tpu_torch.mesh.core import Mesh
from navierstokes_tpu_torch.ops.block import block4_inverse
from navierstokes_tpu_torch.ops.plane_dia import (
    extract_planes,
    from_planes,
    node_offsets_from_scalar,
    plane_nbp,
    spmv_plane,
    to_planes,
)
from navierstokes_tpu_torch.solvers.coarse import (
    CoarseSpace,
    build_aggregates,
    coarse_operator_inverse_dia,
    prolong_planes,
    restrict_planes,
)
from navierstokes_tpu_torch.solvers.deflation import arnoldi
from navierstokes_tpu_torch.solvers.gmres import (
    GMRESResult,
    gmres,
    scalar_type,
)
from navierstokes_tpu_torch.sparse.dia import (
    diag_blocks_from_dia,
    zero_rows_dia,
)


class NewtonStats(NamedTuple):
    iters: int                  # Newton iterations reported (JAX semantics)
    converged: bool
    res_hist: np.ndarray        # (max_newton,) residual norms (nan-padded)
    du_hist: np.ndarray         # (max_newton,) update norms
    lin_iters: int              # total GMRES iterations across the step


@dataclasses.dataclass
class PlanePrep:
    """A prepared two-level operator on the component-plane layout (the JAX
    package's 'tlp' prep): operator planes, plane-form D^{-1}, the dense
    coarse inverse and the optional Chebyshev interval."""

    node_offsets: tuple
    p4: torch.Tensor            # (4, 4 * N_D, nbp) operator planes
    d16: torch.Tensor           # (16, nbp): row 4a+b holds D^{-1}[:, a, b]
    ac_inv: torch.Tensor        # (nc, nc) dense coarse inverse
    cs: CoarseSpace
    nb: int
    nbp: int
    cheby: Optional[tuple] = None   # (theta, delta, degree)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class NavierStokesSolver:
    """Load mesh -> Stokes init -> step -> dump, on one device.

    `device` is explicit ("cuda" or "cpu").  On the card every plane SpMV
    launches K1; on the CPU it runs K1's plain PyTorch version."""

    def __init__(self, mesh: Mesh, cfg: Optional[NSConfig] = None,
                 disc: Optional[Discretization] = None, *,
                 device):
        self.user_cfg = cfg or NSConfig()
        self.cfg = resolve_supported(self.user_cfg, mesh.nv)
        self.device = torch.device(device)
        # TF32 would round the coarse GEMV's operands to 10 mantissa bits:
        # the H100 counterpart of the TPU's bf16 matmul trap (181 vs 69
        # GMRES iterations per step, benchlogs/transient_scaling.txt).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32

        self.dtype = self.cfg.torch_dtype
        self._sc = scalar_type(self.dtype)
        self.disc = disc if disc is not None else build_discretization(
            mesh, dtype=self.dtype, device=self.device)
        nb = mesh.nv
        self._coarse_space = build_aggregates(nb, self.cfg.krylov.coarse_agg)
        self._nbp = plane_nbp(nb, self._coarse_space.nb_pad)
        self._noffs = node_offsets_from_scalar(self.disc.dia_pattern.offsets)
        self._prepared = False
        self.stokes_result: Optional[GMRESResult] = None
        self.history: list = []     # (step, NewtonStats, seconds) per step

    # -- assembly and operator preparation -----------------------------------

    def _assemble_dia(self, terms, reynolds: float) -> torch.Tensor:
        d = self.disc
        return assemble_dia_values(
            d.vol, d.grad, d.h, self.cfg.dt, reynolds, self.cfg.delta,
            d.dia_elem_map, terms=terms, K=d.dia_pattern.K, ndof=d.ndof,
        )

    def _ensure_prepared(self):
        """Build the exact-Jacobian prep and the residual operators once."""
        if self._prepared:
            return
        offs = self.disc.dia_pattern.offsets
        jlin = self._assemble_dia(LINEAR_TERMS, self.cfg.reynolds)
        jlin_bc = zero_rows_dia(offs, jlin, self.disc.bc.is_bc)
        self._exact_prep = self._prepare_operator_dia(jlin_bc)
        # The residual operator differs from the prepared one only in BC
        # rows, which check() masks out of F: share the planes.
        self._res_A = self._exact_prep.p4
        mass = self._assemble_dia(frozenset({"mass_dt_bare"}),
                                  self.cfg.reynolds)
        self._res_M = extract_planes(offs, mass, self.disc.nv,
                                     node_offsets=self._noffs, nbp=self._nbp)
        self._prepared = True

    def _prepare_operator_dia(self, dia_data: torch.Tensor) -> PlanePrep:
        """BC-applied DIA data -> the two-level plane prep."""
        d = self.disc
        cfgk = self.cfg.krylov
        offsets = d.dia_pattern.offsets
        nb, nbp, cs = d.nv, self._nbp, self._coarse_space
        inv_diag = block4_inverse(diag_blocks_from_dia(offsets, dia_data, nb),
                                  pivot_eps=1e-300, shift=1e-8)
        ac_inv = coarse_operator_inverse_dia(cs, offsets, dia_data,
                                             shift=cfgk.coarse_shift)
        p4 = extract_planes(offsets, dia_data, nb, node_offsets=self._noffs,
                            nbp=nbp)
        d16 = torch.zeros((16, nbp), dtype=self.dtype, device=self.device)
        d16[:, :nb] = inv_diag.permute(1, 2, 0).reshape(16, nb)
        return self._maybe_append_cheby(
            PlanePrep(self._noffs, p4, d16, ac_inv, cs, nb, nbp))

    def _maybe_append_cheby(self, prep: PlanePrep) -> PlanePrep:
        """Attach the Chebyshev interval [f*lmax, 1.05*lmax] when
        coarse_cheby > 0 (lmax from a short Arnoldi sweep, once)."""
        deg = self.cfg.krylov.coarse_cheby
        if not deg:
            return prep
        lmax = self._estimate_smoother_lmax(prep)
        frac = self.cfg.krylov.coarse_cheby_fraction
        a, b = frac * lmax, 1.05 * lmax
        prep.cheby = (float((a + b) / 2), float((b - a) / 2), int(deg))
        return prep

    def _estimate_smoother_lmax(self, prep: PlanePrep, m: int = 20) -> float:
        """max |Ritz value| of G = D^{-1}A from an m-step Arnoldi sweep
        started from the BC value vector (ones if that is zero)."""
        rhs = self.disc.bc.value.to(self.dtype)
        if not float(torch.linalg.norm(rhs)):
            rhs = torch.ones_like(rhs)
        rhs = to_planes(rhs, prep.nb, prep.nbp)
        m = min(m, rhs.shape[0] - 2)
        _, _, parts = self._prep_operators(prep)
        _, H = arnoldi(lambda x: parts["apply_Dinv"](parts["apply_A"](x)),
                       rhs, m)
        theta = np.linalg.eigvals(H.cpu().numpy().astype(np.float64)[:m])
        return float(np.max(np.abs(theta)))

    @staticmethod
    def _make_coarse_solve(ac_inv: torch.Tensor):
        """Dense coarse solve: one (nc, nc) GEMV in full float32/float64."""
        def coarse_solve(rc):
            return ac_inv @ rc
        return coarse_solve

    @staticmethod
    def _make_smoother(apply_A, apply_Dinv, cheby):
        """Post-smoother of the two-grid cycle: one Jacobi application, or
        the degree-`deg` Chebyshev polynomial in G = D^{-1}A over
        [theta - delta, theta + delta] (Adams/Brezina/Hu/Tuminaro 2003)."""
        if not cheby:
            return apply_Dinv
        theta, delta, deg = cheby
        sigma1 = theta / delta

        def smooth(s):
            dk = apply_Dinv(s) * (1.0 / theta)
            x = dk
            rho_prev = 1.0 / sigma1
            for _ in range(deg - 1):
                rk = s - apply_A(x)
                rho = 1.0 / (2.0 * sigma1 - rho_prev)
                dk = (rho * rho_prev) * dk + (2.0 * rho / delta) * \
                    apply_Dinv(rk)
                x = x + dk
                rho_prev = rho
            return x

        return smooth

    def _prep_operators(self, prep: PlanePrep):
        """Prep -> (matvec, minv, parts): the left-preconditioned operator
        GMRES iterates, the preconditioner, and the applies of A and D^{-1}
        (for the smoother's lmax estimate)."""
        noffs, p4, d16 = prep.node_offsets, prep.p4, prep.d16
        cs, nb, nbp = prep.cs, prep.nb, prep.nbp
        d3 = d16.reshape(4, 4, nbp)
        coarse_solve = self._make_coarse_solve(prep.ac_inv)

        def apply_A(x):
            return spmv_plane(noffs, p4, x, nb=nb)

        def apply_Dinv(r):
            # block-diagonal D^{-1}: 16 elementwise plane multiplies
            return (d3 * r.reshape(1, 4, nbp)).sum(1).reshape(-1)

        def coarse(r):
            zc = coarse_solve(restrict_planes(cs, r, nbp))
            return prolong_planes(cs, zc, nbp, nb)

        smooth = self._make_smoother(apply_A, apply_Dinv, prep.cheby)

        def minv(r):
            z = coarse(r)
            return z + smooth(r - apply_A(z))

        def matvec(x):
            return minv(apply_A(x))

        return matvec, minv, {"apply_A": apply_A, "apply_Dinv": apply_Dinv}

    def _solve_prepared(self, prep: PlanePrep, rhs: torch.Tensor,
                        solver_cfg) -> GMRESResult:
        """Left-preconditioned GMRES; the Krylov space lives in plane-major
        vectors, converted in and out once per solve."""
        res = self._solve_prepared_raw(
            prep, to_planes(rhs, prep.nb, prep.nbp), solver_cfg)
        return res._replace(x=from_planes(res.x, prep.nb, prep.nbp))

    def _solve_prepared_raw(self, prep: PlanePrep, rhs: torch.Tensor,
                            solver_cfg) -> GMRESResult:
        matvec, b_prep, _ = self._prep_operators(prep)
        return gmres(matvec, b_prep(rhs), restart=solver_cfg.restart,
                     rtol=solver_cfg.rtol, atol=solver_cfg.atol,
                     maxiter=solver_cfg.maxiter)

    # -- Stokes initialization -----------------------------------------------

    def _stokes_dia(self) -> torch.Tensor:
        """The BC-applied Stokes operator in DIA form (`:617-662`), at the
        small Stokes Reynolds number (`:1038`)."""
        stokes = self._assemble_dia(STOKES_TERMS, self.cfg.stokes_reynolds)
        return zero_rows_dia(self.disc.dia_pattern.offsets, stokes,
                             self.disc.bc.is_bc)

    def stokes_init(self) -> torch.Tensor:
        """Initial condition from the steady Stokes solve (`:1094-1095`).
        The operator is prepared from `cfg.krylov`, as in the JAX package;
        `cfg.stokes_krylov` sets the solve's tolerances."""
        prep = self._prepare_operator_dia(self._stokes_dia())
        res = self._solve_prepared(prep, self._stokes_rhs,
                                   self.cfg.stokes_krylov)
        self.stokes_result = res
        return res.x

    @property
    def _stokes_rhs(self) -> torch.Tensor:
        return self.disc.bc.value.to(self.dtype)

    # -- Newton time step ----------------------------------------------------

    def _newton_step(self, u_init, u_old, delta_u_init):
        cfg, nw, sc = self.cfg, self.cfg.newton, self._sc
        dtype = self.dtype
        prep = self._exact_prep
        noffs, nb, nbp = self._noffs, self.disc.nv, self._nbp
        is_bc = self.disc.bc.is_bc
        bc_value = self.disc.bc.value.to(dtype)
        zero = torch.zeros((), dtype=dtype, device=self.device)
        max_newton = nw.max_iter

        # (M/dt) u_old is fixed for the step
        mass_uold = spmv_plane(noffs, self._res_M,
                               to_planes(u_old.to(dtype), nb, nbp), nb=nb)

        def residual(u):
            f = spmv_plane(noffs, self._res_A, to_planes(u, nb, nbp), nb=nb) \
                - mass_uold
            return from_planes(f, nb, nbp)

        def check(u, delta_u):
            """BC insert + residual + the two norms (one host sync)."""
            u = torch.where(is_bc, bc_value, u)
            F = torch.where(is_bc, zero, residual(u))
            norms = torch.stack([torch.linalg.norm(F),
                                 torch.linalg.norm(delta_u)]).cpu().numpy()
            return u, F, norms[0], norms[1]

        rtol, atol = sc(nw.rtol), sc(nw.atol)
        du_tol = sc(nw.atol if nw.du_tol is None else nw.du_tol)

        u, F, rn0, dun0 = check(u_init.to(dtype), delta_u_init.to(dtype))
        delta_u = delta_u_init.to(dtype)
        converged = bool(((rn0 < rtol * rn0) or (rn0 < atol))
                         and (dun0 < du_tol))
        res_h = np.full(max_newton, np.nan, dtype=sc)
        du_h = np.full(max_newton, np.nan, dtype=sc)
        res_h[0], du_h[0] = rn0, dun0
        it, lin_total, stagnated = 0, 0, False
        while it < max_newton and not converged and not stagnated:
            prev_rn = res_h[it]
            sol = self._solve_prepared(prep, -F, cfg.krylov)
            u, delta_u = u + sol.x, sol.x
            lin_total += sol.iters
            u, F, rn, dn = check(u, delta_u)
            it += 1
            if it < max_newton:
                res_h[it], du_h[it] = rn, dn
            converged = bool(((rn < rtol * rn0) or (rn < atol))
                             and (dn < du_tol))
            # stagnation: tiny update, or (f32 only) no residual progress
            stagnated = bool(it > 5 and dn < sc(nw.stol))
            if dtype == torch.float32:
                stagnated = stagnated or bool(it > 2
                                              and rn >= sc(0.9) * prev_rn)
        stats = NewtonStats(iters=min(it + 1, max_newton),
                            converged=converged, res_hist=res_h,
                            du_hist=du_h, lin_iters=lin_total)
        return u, delta_u, stats

    def step(self, u, u_old, delta_u):
        """One backward-Euler step. Returns (u_new, delta_u, stats)."""
        self._ensure_prepared()
        return self._newton_step(u, u_old, delta_u)

    # -- Time loop -----------------------------------------------------------

    def run(self, n_steps: Optional[int] = None, *, u0=None,
            save_dir: Optional[str] = None, save_every: Optional[int] = None,
            monitor: bool = True) -> torch.Tensor:
        """Transient run mirroring the reference CLI (`-save` writes
        `solution_stepNNNN.dat` per saved step).  Each step's stats and
        wall seconds (measured after a device sync) go to `self.history`."""
        cfg = self.cfg
        n_steps = cfg.n_steps if n_steps is None else n_steps
        save_every = cfg.save_every if save_every is None else save_every
        if u0 is None:
            u0 = self.stokes_init()
        u = u0.to(self.dtype)
        u_old = u
        delta_u = torch.zeros_like(u)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)

        for step in range(1, n_steps + 1):
            t0 = time.perf_counter()
            u, delta_u, stats = self.step(u, u_old, delta_u)
            _sync(self.device)
            self.history.append((step, stats, time.perf_counter() - t0))
            if monitor:
                it = stats.iters
                print(f"=== Time step {step} (t={step * cfg.dt:.3f}) === "
                      f"newton={it} lin={stats.lin_iters} "
                      f"|F|={stats.res_hist[max(it - 1, 0)]:.2e} "
                      f"converged={stats.converged}", flush=True)
            if save_dir and save_every and step % save_every == 0:
                write_petsc_vec(
                    os.path.join(save_dir, f"solution_step{step:04d}.dat"), u)
            u_old = u
        return u
