"""The transient Navier–Stokes engine: Stokes initialization, then
backward-Euler steps with Newton.

Pipeline per run (the reference's `src/solve_newton.c:925-1323`):
  1. Stokes initialization: assemble the steady Stokes operator with the
     small Stokes Reynolds number, apply Dirichlet rows, solve.
  2. Time loop: per Newton iteration insert BC values, evaluate the
     residual, test convergence, solve J du = -F.  With the exact Jacobian
     (the default) J is constant and prepared once; with
     `jacobian='reference'` every iteration assembles the convection terms
     at u, adds the once-assembled J_linear, zeroes the BC rows and
     prepares that operator (`:1245-1246`).  The residual is
     F = A_lin u - (M/dt) u_old (two SpMVs, `residual='operator'`) or the
     element-wise contraction and scatter-add of `assemble_residual`.

The prepared-operator kinds are those of the JAX package's
`model/navier_stokes.py`, one dataclass each:

  - 'tlp' (`PlanePrep`): the two-level preconditioner on the
    component-plane layout (spmv='plane', the f32 flagship), every
    operator apply through kernel K1 (`ops/plane_dia.py`);
  - 'tl' (`ScalarTwoLevelPrep`): the same two-level cycle on the
    scalar-DIA layout (spmv auto/xla/pallas);
  - 'sch' (`SchurPrep`): the pressure-Schur block preconditioner on the
    plane layout (the f32 'auto' tier above 150k rows): F_hat and S_hat
    two-grid cycles, every sub-block apply (4x4, F 3x3, A_pu 1x3, A_up
    3x1, S_hat 1x1 on the sumset of the node offsets) through K1, the
    host algebra in `solvers/schur.py`;
  - 'bj' (`BlockJacobiPrep`): block-Jacobi folded into the operator,
    S = D^{-1} A, with the Neumann boost (the float64 default);
  - 'defl' (`DeflatedPrep`): a recycled pair (U, Q) around any of the
    first four but 'sch' (`solvers/deflation.py`, deflation_k > 0).

Each kind's preconditioner is composed from the cycle pieces of
`solvers/cycle.py` (block D^{-1}, smoother, two-grid cycle, plane coarse
correction, Neumann series), as are the distributed solver's.

The scalar-DIA applies (A, S, the 7-diagonal D^{-1}, the multilevel
coarse level, the scalar residual) run kernel K2 (`ops/dia.py`).  With
`cgs2` 'pallas' or 'pallas_comp', every GMRES solve (Stokes and Newton, on
each kind, deflated too) orthogonalizes through kernel K3 (`ops/cgs2.py`).
Both two-level kinds take a dense coarse inverse (piecewise constant, or
smoothed aggregation with coarse_smooth_omega), 'tlp' the linear basis,
and above `coarse_dense_max` the multilevel coarse level.  The Krylov
method is GMRES, CG or CA-GMRES (`method`).  Newton and the Krylov
methods are Python loops over device tensors; the host reads only the
norms and small matrices it branches on, each read through
`utils/profiling.fetch`.

The exact-Jacobian prep, which every Newton iteration solves again, keeps
its closures (`HeldOperators`, built once) and, for a plain GMRES solve
(`cgs2='xla'`) on one CUDA tensor, the CUDA graphs of its inner iterations
(`solvers/graphs.py`): the rule `graphs.engages` decides, no option.  Every
other solve (Stokes, reference mode, deflation, CA-GMRES, CG, K3, the CPU)
runs the eager loop.

Spans (`utils/profiling`, off unless enabled): `step`, `newton.check`,
`krylov.solve`, in reference mode `newton.jacobian` and `newton.prep`; the
closures of `_prep_operators` as `op.apply`, `pc.apply`, `pc.coarse` and
`pc.smooth`, on 'sch' with `pc.fhat` and `pc.shat` around its two
cycles; set-up as `setup.discretization`, `setup.prepare`,
`setup.assemble`, `setup.operator` (with `setup.coarse` and
`setup.cheby_lmax`; on 'sch' `setup.schur` with a `setup.schur.<stage>`
span per stage of its algebra), `setup.residual_ops` and `stokes`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from navierstokes_tpu_torch.config import (
    NSConfig,
    resolve_supported,
    second_level_agg,
)
from navierstokes_tpu_torch.fem.assembly import (
    LINEAR_TERMS,
    NONLINEAR_TERMS,
    STOKES_TERMS,
    Discretization,
    assemble_dia_values,
    assemble_residual,
    build_discretization,
    local_fields,
)
from navierstokes_tpu_torch.io.checkpoint import save_checkpoint
from navierstokes_tpu_torch.io.dat import write_petsc_vec
from navierstokes_tpu_torch.io.vtu import write_pvd, write_vtu
from navierstokes_tpu_torch.mesh.core import Mesh
from navierstokes_tpu_torch.ops import dia as dia_ops
from navierstokes_tpu_torch.ops.block import block4_inverse
from navierstokes_tpu_torch.ops.plane_dia import (
    extract_planes,
    from_planes,
    node_offsets_from_scalar,
    plane_nbp,
    spmv_plane,
    spmv_planes,
    to_planes,
)
from navierstokes_tpu_torch.solvers import schur as sch
from navierstokes_tpu_torch.utils.precision import no_tf32, no_tf32_operators
from navierstokes_tpu_torch.utils.profiling import (
    active,
    fetch,
    span,
    spanned,
    wrap,
)
from navierstokes_tpu_torch.solvers import cycle
from navierstokes_tpu_torch.solvers.cg import cg
from navierstokes_tpu_torch.solvers.coarse import (
    CoarseSpace,
    build_aggregates,
    build_linear_weights,
    coarse_dia_offsets,
    coarse_operator_dia,
    coarse_operator_inverse_dia,
    linear_coarse_inverse_dia,
    prolong,
    prolong_planes_linear,
    restrict,
    restrict_planes_linear,
    smoothed_coarse_inverse_dia,
)
from navierstokes_tpu_torch.solvers.deflation import (
    arnoldi,
    harmonic_ritz_basis,
    recycle_space,
)
from navierstokes_tpu_torch.solvers import graphs as krylov_graphs
from navierstokes_tpu_torch.solvers.gmres import (
    GMRESResult,
    gmres,
    scalar_type,
)
from navierstokes_tpu_torch.solvers.sstep import ca_gmres, newton_shifts
from navierstokes_tpu_torch.sparse.dia import (
    DINV_OFFSETS,
    block_diag_to_dia,
    diag_blocks_from_dia,
    scale_rows_dia,
    zero_rows_dia,
)


class NewtonStats(NamedTuple):
    iters: int                  # Newton iterations reported (JAX semantics)
    converged: bool
    res_hist: np.ndarray        # (max_newton,) residual norms (nan-padded)
    du_hist: np.ndarray         # (max_newton,) update norms
    lin_iters: int              # total GMRES iterations across the step


@dataclasses.dataclass
class DenseCoarse:
    """Dense coarse level: A_c^{-1}, one (nc, nc) GEMV per apply."""

    ac_inv: torch.Tensor


@dataclasses.dataclass
class MultilevelCoarse:
    """Sparse coarse level (the JAX package's 'ml'): A_c in scalar-DIA form,
    solved by two-grid cycles with a dense second aggregation level and
    damped block-Jacobi smoothing."""

    offsets: tuple              # coarse DIA offsets (coarse_dia_offsets)
    ac1: torch.Tensor           # (Kc, nc) level-1 operator
    invd1: torch.Tensor         # (7, nc) level-1 block-diagonal inverse
    cs2: CoarseSpace            # second aggregation level
    ac2_inv: torch.Tensor       # (nc2, nc2) dense level-2 inverse


@dataclasses.dataclass
class DenseLinearCoarse:
    """Dense coarse level of the per-aggregate linear basis (the JAX
    package's 'dense_lin', 'tlp' only): A_c^{-1} over 16 DoF per aggregate
    and the basis weight planes w (4, nb_pad)."""

    ac_inv: torch.Tensor
    w: torch.Tensor


Coarse = Union[DenseCoarse, DenseLinearCoarse, MultilevelCoarse]


@dataclasses.dataclass
class PlanePrep:
    """A prepared two-level operator on the component-plane layout (the JAX
    package's 'tlp' prep): operator planes, plane-form D^{-1}, the coarse
    level and the optional Chebyshev interval."""

    kind = "tlp"
    node_offsets: tuple
    p4: torch.Tensor            # (4, 4 * N_D, nbp) operator planes
    d16: torch.Tensor           # (16, nbp): row 4a+b holds D^{-1}[:, a, b]
    coarse: Coarse
    cs: CoarseSpace
    nb: int
    nbp: int
    cheby: Optional[tuple] = None   # (theta, delta, degree)


@dataclasses.dataclass
class ScalarTwoLevelPrep:
    """A prepared two-level operator on the scalar-DIA layout (the JAX
    package's 'tl' prep): the operator, the 7-diagonal D^{-1}, the coarse
    level and the optional Chebyshev interval."""

    kind = "tl"
    offsets: tuple
    data: torch.Tensor          # (K, ndof) operator (bf16 with matvec_dtype)
    invd: torch.Tensor          # (7, ndof) D^{-1}, offsets DINV_OFFSETS
    coarse: Coarse
    cs: CoarseSpace
    cheby: Optional[tuple] = None


@dataclasses.dataclass
class BlockJacobiPrep:
    """Block-Jacobi folded into the operator (the JAX package's 'bj' prep):
    S = D^{-1} A in scalar-DIA form, and D^{-1} for the right-hand side."""

    kind = "bj"
    s_offsets: tuple
    s_data: torch.Tensor        # (K', ndof) (bf16 with matvec_dtype)
    invd: torch.Tensor          # (7, ndof)


@dataclasses.dataclass
class SchurPrep:
    """A prepared pressure-Schur block preconditioner on the plane layout
    (the JAX package's 'sch' prep): the operator planes and the sub-block
    planes for K1, the plane-form diag(F)^{-1}, S_hat and its diagonal
    inverse, the two dense coarse inverses and the smoother intervals."""

    kind = "sch"
    node_offsets: tuple
    p4: torch.Tensor            # (4, 4 * N_D, nbp) operator planes
    p_f: torch.Tensor           # (3, 3 * N_D, nbp) F
    p_b: torch.Tensor           # (1, 3 * N_D, nbp) A_pu = -B
    p_g: Optional[torch.Tensor]  # (3, N_D, nbp) A_up = B^T ('full' only)
    d9: torch.Tensor            # (9, nbp): row 3a+b is diag(F)^{-1}[:, a, b]
    s_offsets: tuple            # node offsets of S_hat (sumset band)
    s_planes: torch.Tensor      # (1, N_S, nbp) S_hat
    s_dinv: torch.Tensor        # (nbp,) 1 / diag(S_hat)
    vc_inv: torch.Tensor        # (3 n_agg, 3 n_agg) velocity coarse inverse
    sc_inv: torch.Tensor        # (n_agg, n_agg) S_hat coarse inverse
    cs: CoarseSpace
    cheby_v: Optional[tuple]    # (theta, delta, degree) or None: one Jacobi
    cheby_s: Optional[tuple]
    shape: str                  # 'lower' | 'full'
    nb: int
    nbp: int
    # host-clock seconds of the preparation's stages, by the name of each
    # stage's span (empty when carried over from the JAX package)
    seconds: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DeflatedPrep:
    """A prepared operator with a GCRO recycled pair (the JAX package's
    ("defl", prep, U, Q)): T U^T = Q^T, Q Q^T = I, both (k, n) on the
    inner prep's vector layout."""

    kind = "defl"
    inner: Union[PlanePrep, ScalarTwoLevelPrep, BlockJacobiPrep]
    U: torch.Tensor
    Q: torch.Tensor


Prep = Union[PlanePrep, ScalarTwoLevelPrep, SchurPrep, BlockJacobiPrep,
             DeflatedPrep]


@dataclasses.dataclass
class HeldOperators:
    """The closures of the exact-Jacobian prep, which every Newton iteration
    solves again, built once and held, with the CUDA graphs of its GMRES
    iterations.  Closures carry their spans or not as spans were when they
    were built (`utils/profiling.wrap`), so they are built again where the
    span log changed since."""

    prep: Prep
    log: object                 # `profiling.active()` at the build
    matvec: Callable
    b_prep: Callable
    graphs: Optional[krylov_graphs.IterationGraphs] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _plane_shape(prep) -> Optional[tuple]:
    """(nb, nbp) of a plane-layout prep ('tlp', 'sch'), else None."""
    if isinstance(prep, (PlanePrep, SchurPrep)):
        return prep.nb, prep.nbp
    return None


CHEBY_SINGLE_CHIP = ("coarse_cheby is single-chip only (the distributed "
                     "solve paths smooth with one Jacobi application)")
DEFLATION_SINGLE_CHIP = ("deflation_k is single-chip only (the recycled "
                         "GEMVs are not sharded); drop it or run "
                         "single-device")


class NavierStokesSolver:
    """Load mesh -> Stokes init -> step -> dump, on one device.

    `device` is explicit ("cuda" or "cpu").  On the card every SpMV
    launches K1 (plane layout) or K2 (scalar-DIA layout; spmv='xla' runs
    K2's plain version instead); on the CPU the kernels' plain PyTorch
    versions run.  The distributed subclass
    (`parallel.DistributedNavierStokesSolver`) turns off the options it
    cannot run through the three flags below and overrides the layout and
    apply hooks."""

    # preconditioner='auto' resolves to the single-device tiers (Chebyshev,
    # Schur); under distribution to plain two_level, with a warning
    _auto_single_chip = True
    _supports_cheby = True
    _supports_deflation = True

    def __init__(self, mesh: Mesh, cfg: Optional[NSConfig] = None,
                 disc: Optional[Discretization] = None, *,
                 device):
        self.user_cfg = cfg or NSConfig()
        self.cfg = resolve_supported(self.user_cfg, mesh.nv,
                                     single_chip=self._auto_single_chip)
        if self.cfg.krylov.coarse_cheby and not self._supports_cheby:
            raise ValueError(CHEBY_SINGLE_CHIP)
        if self.cfg.krylov.deflation_k and not self._supports_deflation:
            raise ValueError(DEFLATION_SINGLE_CHIP)
        self.device = torch.device(device)

        self.dtype = self.cfg.torch_dtype
        self._sc = scalar_type(self.dtype)
        if disc is None:
            with span("setup.discretization"):
                disc = build_discretization(mesh, dtype=self.dtype,
                                            device=self.device,
                                            ell_slots=self.cfg.ell_slots)
        self.disc = disc
        nb = mesh.nv
        kr = self.cfg.krylov
        self._coarse_space = build_aggregates(nb, kr.coarse_agg)
        self._coarse_l2 = None          # (offsets, CoarseSpace), built once
        self._linear_w = None           # linear-basis weights, built once
        self._ca_shifts = None          # Newton-basis shifts ('newton')
        self._plane = kr.spmv == "plane" and \
            kr.preconditioner in ("two_level", "schur")
        if self._plane:
            self._noffs = node_offsets_from_scalar(
                self.disc.dia_pattern.offsets)
            self._nbp = self._plane_nbp()
        self._prepared = False
        self._exact_prep: Optional[Prep] = None
        self._held: Optional[HeldOperators] = None
        self.stokes_result: Optional[GMRESResult] = None
        self.history: list = []     # (step, NewtonStats, seconds) per step

    def _plane_nbp(self) -> int:
        """The padded node count of the plane layout (the distributed
        subclass pads to whole shards)."""
        return plane_nbp(self.disc.nv, self._coarse_space.nb_pad)

    @property
    def prep_kind(self) -> str:
        """The prepared-operator kind this config builds: 'tlp', 'tl',
        'sch' or 'bj' (deflation wraps the exact Jacobian's, 'defl')."""
        p = self.cfg.krylov.preconditioner
        if p == "block_jacobi":
            return BlockJacobiPrep.kind
        if p == "schur":
            return SchurPrep.kind
        return PlanePrep.kind if self._plane else ScalarTwoLevelPrep.kind

    @property
    def _reference(self) -> bool:
        return self.cfg.jacobian == "reference"

    # -- assembly and operator preparation -----------------------------------

    @spanned("setup.assemble")
    def _assemble_dia(self, terms, reynolds: float,
                      UL: Optional[torch.Tensor] = None) -> torch.Tensor:
        d = self.disc
        return assemble_dia_values(
            d.vol, d.grad, d.h, self.cfg.dt, reynolds, self.cfg.delta,
            d.dia_elem_map, terms=terms, K=d.dia_pattern.K, ndof=d.ndof,
            UL=UL,
        )

    @no_tf32
    def _ensure_prepared(self):
        """Build J_linear, the exact-Jacobian prep (with its recycled pair
        and Newton-basis shifts) and the residual operators, once."""
        if self._prepared:
            return
        with span("setup.prepare"):
            cfgk = self.cfg.krylov
            offs = self.disc.dia_pattern.offsets
            jlin = self._assemble_dia(LINEAR_TERMS, self.cfg.reynolds)
            prep = None
            if self._reference:
                # every Newton iteration adds the convection terms to J_linear
                self._jlin = jlin
            else:
                prep = self._prepare_operator_dia(
                    zero_rows_dia(offs, jlin, self.disc.bc.is_bc))
                if cfgk.deflation_k:
                    prep = self._build_deflation(prep)
                if cfgk.method == "ca_gmres" and cfgk.ca_basis == "newton":
                    inner = prep.inner if isinstance(prep, DeflatedPrep) \
                        else prep
                    self._ca_shifts = self._build_ca_shifts(
                        inner, min(cfgk.restart, 16))
            self._exact_prep = prep
            if self.cfg.residual == "operator":
                self._res_A, self._res_M = self._residual_operators(prep, jlin)
        self._prepared = True

    @spanned("setup.residual_ops")
    def _residual_operators(self, prep, jlin: torch.Tensor) -> tuple:
        """(A_lin, M/dt) of the operator-form residual, on the layout the
        residual runs on: planes where the solver runs the plane layout,
        else scalar-DIA.

        An exact two-level (or Schur) prep differs from the residual
        operator only in BC rows, which check() masks out of F: share it.
        The block-Jacobi S is pre-scaled by D^{-1}, so 'bj' keeps its own,
        and so does 'tl' with matvec_dtype set: Newton's |F| is taken with
        the full-precision operator, as in the JAX package."""
        offs = self.disc.dia_pattern.offsets
        mass = self._assemble_dia(frozenset({"mass_dt_bare"}),
                                  self.cfg.reynolds)
        inner = prep.inner if isinstance(prep, DeflatedPrep) else prep
        if self._plane:
            def planes(data):
                return extract_planes(offs, data, self.disc.nv,
                                      node_offsets=self._noffs,
                                      nbp=self._nbp)
            res_a = inner.p4 if inner is not None else planes(jlin)
            return res_a, planes(mass)
        share = isinstance(inner, ScalarTwoLevelPrep) and \
            self.cfg.krylov.matvec_dtype is None
        return (inner.data if share else jlin), mass

    def release_assembly_buffers(self) -> None:
        """Free the assembly-time device tensors (element geometry and the
        element scatter map: ~7 GB at matrix 10).  With the exact Jacobian
        and the operator residual every step works off the prepared
        operators alone; call after `stokes_init`, which assembles.  Every
        other mode assembles in each Newton iteration: RuntimeError."""
        if not (self.cfg.jacobian == "exact"
                and self.cfg.residual == "operator"):
            raise RuntimeError(
                "release_assembly_buffers requires jacobian='exact' and "
                "residual='operator' (other modes assemble per step)")
        self._ensure_prepared()
        d = self.disc
        d.tets = d.vol = d.grad = d.h = d.dia_elem_map = None

    @spanned("setup.operator")
    def _prepare_operator_dia(self, dia_data: torch.Tensor) -> Prep:
        """BC-applied DIA data -> the prep of the configured kind."""
        cfgk = self.cfg.krylov
        if cfgk.preconditioner == "schur":
            return self._prepare_operator_schur(dia_data)
        d = self.disc
        offsets = d.dia_pattern.offsets
        nb = d.nv
        inv_diag = block4_inverse(diag_blocks_from_dia(offsets, dia_data, nb),
                                  pivot_eps=1e-300, shift=1e-8)
        # matvec_dtype: the operator GMRES applies is stored in bf16 (K2's
        # bf16 form); D^{-1} and the coarse level come from the
        # full-precision operator, as in the JAX package.
        mv_dtype = None if cfgk.matvec_dtype is None else \
            getattr(torch, cfgk.matvec_dtype)
        if cfgk.preconditioner == "block_jacobi":
            s_offsets, s_data = scale_rows_dia(d.dia_pattern, dia_data,
                                               inv_diag)
            if mv_dtype is not None:
                s_data = s_data.to(mv_dtype)
            return BlockJacobiPrep(s_offsets, s_data,
                                   block_diag_to_dia(inv_diag).data)
        coarse = self._prepare_coarse(offsets, dia_data, inv_diag)
        cs = self._coarse_space
        if self._plane:
            nbp = self._nbp
            p4 = extract_planes(offsets, dia_data, nb,
                                node_offsets=self._noffs, nbp=nbp)
            d16 = torch.zeros((16, nbp), dtype=self.dtype, device=self.device)
            d16[:, :nb] = inv_diag.permute(1, 2, 0).reshape(16, nb)
            prep = PlanePrep(self._noffs, p4, d16, coarse, cs, nb, nbp)
        else:
            if mv_dtype is not None:
                # cast after the coarse level: the Chebyshev interval is
                # then estimated on the cast operator
                dia_data = dia_data.to(mv_dtype)
            prep = ScalarTwoLevelPrep(offsets, dia_data,
                                      block_diag_to_dia(inv_diag).data,
                                      coarse, cs)
        return self._maybe_append_cheby(prep)

    @spanned("setup.schur")
    def _prepare_operator_schur(self, dia_data: torch.Tensor) -> SchurPrep:
        """BC-applied DIA data -> the 'sch' prep.

        The data comes to the host once; the 3x3 diag(F)^{-1}, S_hat =
        D + B diag(F)^{-1} B^T, the two dense coarse inverses and the
        Chebyshev intervals are built there in float64
        (`solvers/schur.py`), as in the JAX package.  The device half is
        plane stacks for K1: the 4x4 operator p4 (the GMRES matvec and the
        residual), F (3x3), A_pu = -B (1x3), A_up = B^T (3x1, 'full'
        only) and S_hat (1x1 on its own offsets).  Each stage runs in a
        span `setup.schur.<stage>`, and its seconds in `SchurPrep.seconds`,
        under the span's name, run from the previous stage's end to its
        own: the stages tile the preparation, each span inside its
        stage."""
        cfgk = self.cfg.krylov
        offsets = self.disc.dia_pattern.offsets
        nb, nbp, noffs = self.disc.nv, self._nbp, self._noffs
        cs = self._coarse_space
        dtype, dev = self.dtype, self.device

        def planes(host: np.ndarray) -> torch.Tensor:
            """Host (n_out, NT, nb) -> device (n_out, NT, nbp)."""
            out = torch.zeros(host.shape[:-1] + (nbp,), dtype=dtype,
                              device=dev)
            out[..., :nb] = torch.as_tensor(host).to(dev, dtype)
            return out

        def padded(host: np.ndarray) -> torch.Tensor:
            """Host (..., nb) -> device (..., nbp), zero rows nb..nbp."""
            pad = [(0, 0)] * (host.ndim - 1) + [(0, nbp - nb)]
            return torch.as_tensor(np.pad(host, pad)).to(dev, dtype)

        seconds = {}
        last = time.perf_counter()

        @contextlib.contextmanager
        def stage(name: str):
            nonlocal last
            with span(name):
                yield
            now = time.perf_counter()
            seconds[name], last = now - last, now

        with stage("setup.schur.to_host"):
            p4 = extract_planes(offsets, dia_data, nb, node_offsets=noffs,
                                nbp=nbp)
            dd = dia_data.cpu().numpy()
        with stage("setup.schur.blocks"):
            a_blk = sch.split_blocks(offsets, dd, nb, noffs)
            fd_inv = sch.diag_f_inverse(a_blk, noffs)

        with stage("setup.schur.planes"):
            # Sub-block planes in `plane_terms` order, term j = iD * n_in +
            # b: F[a, j] = A_blk[iD, :, a, b] and A_pu[0, j] =
            # A_blk[iD, :, 3, b] (n_in = 3), A_up[a, iD] = A_blk[iD, :, a,
            # 3] (n_in = 1).
            n_d = len(noffs)
            pf = a_blk[:, :, :3, :3].transpose(2, 0, 3, 1).reshape(
                3, 3 * n_d, nb)
            pb = a_blk[:, :, 3, :3].transpose(0, 2, 1).reshape(
                1, 3 * n_d, nb)
            p_g = None
            if cfgk.schur_shape == "full":
                p_g = planes(a_blk[:, :, :3, 3].transpose(2, 0, 1))
            # (nb, 3, 3) -> (9, nbp): row 3a+b holds diag(F)^{-1}[:, a, b]
            d9 = padded(fd_inv.transpose(1, 2, 0).reshape(9, nb))

        with stage("setup.schur.s_hat"):
            s_offs, s_np = sch.build_schur_dia(a_blk, noffs, nb, fd_inv)
            sd = s_np[s_offs.index(0)].copy()
            sd[sd == 0.0] = 1.0
            sdinv = 1.0 / sd
        with stage("setup.schur.coarse"):
            vc_inv = sch.velocity_coarse_inverse(cs, a_blk, noffs,
                                                 shift=cfgk.coarse_shift)
            sc_inv = sch.scalar_coarse_inverse(cs, s_offs, s_np,
                                               shift=cfgk.coarse_shift)

        frac = cfgk.coarse_cheby_fraction
        with stage("setup.schur.power"):
            cheby_s = cheby_v = None
            if cfgk.schur_cheby:
                cheby_s = cycle.cheby_interval(
                    sch.power_lmax_schur(s_offs, s_np, sdinv), frac,
                    cfgk.schur_cheby)
            if cfgk.schur_v_cheby:
                cheby_v = cycle.cheby_interval(
                    sch.power_lmax_velocity(a_blk, noffs, fd_inv), frac,
                    cfgk.schur_v_cheby)
        with stage("setup.schur.to_device"):
            prep = SchurPrep(
                noffs, p4, planes(pf), planes(pb), p_g, d9, s_offs,
                planes(s_np[None]), padded(sdinv),
                torch.as_tensor(vc_inv).to(dev, dtype),
                torch.as_tensor(sc_inv).to(dev, dtype), cs, cheby_v,
                cheby_s, cfgk.schur_shape, nb, nbp, seconds)
        return prep

    @spanned("setup.coarse")
    def _prepare_coarse(self, offsets: tuple, dia_data: torch.Tensor,
                        inv_diag: torch.Tensor) -> Coarse:
        """The coarse level: the linear basis's dense inverse
        (coarse_basis='linear'); a dense inverse when nc <=
        coarse_dense_max (of the smoothed-aggregation Petrov-Galerkin
        matrix with coarse_smooth_omega); else the multilevel level (sparse
        A_c, dense second level).  Every dense inverse is taken on the
        host in float64, in every Jacobian mode."""
        cfgk = self.cfg.krylov
        cs = self._coarse_space
        if cfgk.coarse_basis == "linear":
            if self._linear_w is None:
                w = build_linear_weights(cs, self.disc.mesh.coords)
                self._linear_w = (w, torch.as_tensor(w).to(self.device,
                                                            self.dtype))
            w_host, w_dev = self._linear_w
            return DenseLinearCoarse(linear_coarse_inverse_dia(
                cs, offsets, dia_data, w_host, shift=cfgk.coarse_shift),
                w_dev)
        if cs.nc <= cfgk.coarse_dense_max:
            if cfgk.coarse_smooth_omega:
                return DenseCoarse(smoothed_coarse_inverse_dia(
                    cs, offsets, dia_data, inv_diag,
                    omega=cfgk.coarse_smooth_omega,
                    shift=cfgk.coarse_shift))
            return DenseCoarse(coarse_operator_inverse_dia(
                cs, offsets, dia_data, shift=cfgk.coarse_shift))
        if self._coarse_l2 is None:
            self._coarse_l2 = (
                coarse_dia_offsets(offsets, cs.agg_size),
                build_aggregates(cs.n_agg, second_level_agg(
                    cs.nc, cfgk.coarse_dense_max)))
        c_off, cs2 = self._coarse_l2
        ac1 = coarse_operator_dia(cs, offsets, dia_data, c_off,
                                  shift=cfgk.coarse_shift)
        invd1 = block_diag_to_dia(block4_inverse(
            diag_blocks_from_dia(c_off, ac1, cs.n_agg), pivot_eps=1e-300,
            shift=1e-8)).data
        ac2_inv = coarse_operator_inverse_dia(cs2, c_off, ac1,
                                              shift=cfgk.coarse_shift)
        return MultilevelCoarse(c_off, ac1, invd1, cs2, ac2_inv)

    def _maybe_append_cheby(self, prep):
        """Attach the Chebyshev interval [f*lmax, 1.05*lmax] when
        coarse_cheby > 0 (lmax from a short Arnoldi sweep, once)."""
        deg = self.cfg.krylov.coarse_cheby
        if not deg:
            return prep
        prep.cheby = cycle.cheby_interval(
            self._estimate_smoother_lmax(prep),
            self.cfg.krylov.coarse_cheby_fraction, deg)
        return prep

    @spanned("setup.cheby_lmax")
    def _estimate_smoother_lmax(self, prep, m: int = 20) -> float:
        """max |Ritz value| of G = D^{-1}A from an m-step Arnoldi sweep
        started from the BC value vector (ones if that is zero)."""
        rhs = self._arnoldi_rhs(prep, ones_if_zero=True)
        m = min(m, rhs.shape[0] - 2)
        _, _, parts = self._prep_operators(prep)
        _, H = arnoldi(lambda x: parts["apply_Dinv"](parts["apply_A"](x)),
                       rhs, m)
        theta = np.linalg.eigvals(H.cpu().numpy().astype(np.float64)[:m])
        return float(np.max(np.abs(theta)))

    # -- operator applies ----------------------------------------------------

    def _spmv(self, offsets: tuple, data: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
        """Every scalar-DIA apply (the JAX package's `_spmv` and
        `_spmv_small`): K2 on the card for spmv auto/pallas/plane, in f32
        and f64 alike; spmv='xla' runs K2's plain version, kernel-free."""
        if self.cfg.krylov.spmv == "xla":
            return dia_ops.spmv_dia_plain(offsets, data, x)
        return dia_ops.spmv_dia(offsets, data, x)

    def _make_coarse_solve(self, coarse: Coarse):
        """Coarse-level solve, shared by 'tl' and 'tlp'.  Dense: one
        (nc, nc) GEMV in full float32/float64.  Multilevel: the sparse
        level-1 system is solved by two-grid cycles (dense level-2
        correction, then damped level-1 block-Jacobi sweeps)."""
        if isinstance(coarse, (DenseCoarse, DenseLinearCoarse)):
            return cycle.dense_solve(coarse.ac_inv)

        kr = self.cfg.krylov
        c_off, ac1, cs2 = coarse.offsets, coarse.ac1, coarse.cs2

        def ml_solve(rc):
            zc = None           # zero start: the first residual is rc
            for _ in range(kr.coarse_ml_cycles):
                r1 = rc if zc is None else rc - self._spmv(c_off, ac1, zc)
                corr = prolong(cs2, coarse.ac2_inv @ restrict(cs2, r1))
                zc = corr if zc is None else zc + corr
                for _ in range(kr.coarse_ml_smooth):
                    # damp < 1 keeps the sweeps stable when smoothing:
                    # undamped Jacobi diverges on the saddle-point coarse
                    # operator (JAX SolverConfig.coarse_ml_damp)
                    zc = zc + kr.coarse_ml_damp * self._spmv(
                        DINV_OFFSETS, coarse.invd1,
                        rc - self._spmv(c_off, ac1, zc))
            return zc
        return ml_solve

    @no_tf32_operators
    def _prep_operators(self, prep: Prep):
        """Prep -> (matvec, b_prep, parts): the left-preconditioned operator
        GMRES iterates, the map of the raw right-hand side to the
        preconditioned one, and the component applies (apply_A and
        apply_Dinv feed the smoother's lmax estimate; `bench/gmres_decomp`
        times every entry)."""
        if isinstance(prep, BlockJacobiPrep):
            return self._bj_operators(prep)
        if isinstance(prep, SchurPrep):
            return self._schur_operators(prep)
        coarse_solve = self._make_coarse_solve(prep.coarse)
        if isinstance(prep, PlanePrep):
            noffs, p4, nb, nbp, cs = (prep.node_offsets, prep.p4, prep.nb,
                                      prep.nbp, prep.cs)

            @wrap("op.apply")
            def apply_A(x):
                return spmv_plane(noffs, p4, x, nb=nb)

            apply_Dinv = cycle.block_dinv(prep.d16, 4)
            if isinstance(prep.coarse, DenseLinearCoarse):
                w = prep.coarse.w

                def coarse_p0(r):
                    zc = coarse_solve(restrict_planes_linear(cs, r, nbp, w))
                    return prolong_planes_linear(cs, zc, nbp, nb, w)
            else:
                coarse_p0 = cycle.plane_coarse(cs, coarse_solve, nbp, nb, 4)
        else:
            cs = prep.cs

            @wrap("op.apply")
            def apply_A(x):
                return self._spmv(prep.offsets, prep.data, x)

            def apply_Dinv(r):
                return self._spmv(DINV_OFFSETS, prep.invd, r)

            def coarse_p0(r):
                return prolong(cs, coarse_solve(restrict(cs, r)))

        om = self.cfg.krylov.coarse_smooth_omega

        @wrap("pc.coarse")
        def coarse(r):
            z = coarse_p0(r)
            if om:
                # the smoothed-aggregation prolongator, applied on the fly:
                # P zc = (I - om D^{-1} A) P0 zc (the Galerkin matrix of
                # smoothed_coarse_dense_matrix)
                z = z - om * apply_Dinv(apply_A(z))
            return z

        return cycle.two_level_operators(apply_A, apply_Dinv, coarse,
                                         prep.cheby)

    def _schur_operators(self, prep: SchurPrep):
        """'sch': GMRES on M^{-1} A with M the block lower-triangular
        [[F_hat, 0], [A_pu, S_hat]] (A_pu = -B); schur_shape='full' adds
        the A_up = B^T back-substitution.  F_hat and S_hat are two-grid
        cycles: the dense coarse GEMV, then the smoother.  Every sub-block
        apply is one K1 launch."""
        noffs, nb, nbp, cs = prep.node_offsets, prep.nb, prep.nbp, prep.cs

        @wrap("op.apply")
        def apply_A(x):
            return spmv_plane(noffs, prep.p4, x, nb=nb)

        def apply_F(xu):
            return spmv_planes(noffs, prep.p_f, xu, n_in=3, nb=nb)

        def apply_pu(xu):
            return spmv_planes(noffs, prep.p_b, xu, n_in=3, nb=nb)

        def apply_S(xp):
            return spmv_planes(prep.s_offsets, prep.s_planes, xp, n_in=1,
                               nb=nb)

        def dinv_s(rp):
            return prep.s_dinv * rp

        def block_cycle(apply_B, dinv, cheby, ac_inv, n, name):
            coarse = wrap("pc.coarse")(cycle.plane_coarse(
                cs, cycle.dense_solve(ac_inv), nbp, nb, n))
            return cycle.two_grid(coarse, cycle.smoother(apply_B, dinv, cheby),
                                  apply_B, name)

        fhat = block_cycle(apply_F, cycle.block_dinv(prep.d9, 3),
                           prep.cheby_v, prep.vc_inv, 3, "pc.fhat")
        shat = block_cycle(apply_S, dinv_s, prep.cheby_s, prep.sc_inv, 1,
                           "pc.shat")

        @wrap("pc.apply")
        def minv(r):
            r2 = r.reshape(4, nbp)
            zu = fhat(r2[:3].reshape(-1))
            zp = shat(r2[3] - apply_pu(zu))
            if prep.shape == "full":
                zu = zu - fhat(spmv_planes(noffs, prep.p_g, zp, n_in=1,
                                           nb=nb))
            return torch.cat([zu, zp])

        def matvec(x):
            return minv(apply_A(x))

        return matvec, minv, {"apply_A": apply_A, "apply_F": apply_F,
                              "apply_S": apply_S, "fhat": fhat,
                              "shat": shat, "minv": minv}

    def _bj_operators(self, prep: BlockJacobiPrep):
        """'bj': GMRES on the Neumann-boosted S = D^{-1} A."""
        @wrap("op.apply")
        def apply_S(x):
            return self._spmv(prep.s_offsets, prep.s_data, x)

        def apply_Dinv(r):
            return self._spmv(DINV_OFFSETS, prep.invd, r)

        return cycle.neumann_operators(apply_S, apply_Dinv,
                                       self.cfg.krylov.neumann_order)

    @spanned("krylov.solve")
    @no_tf32
    def _solve_prepared(self, prep: Prep, rhs: torch.Tensor,
                        solver_cfg) -> GMRESResult:
        """Left-preconditioned solve.  On the plane layout the Krylov space
        lives in plane-major vectors, converted in and out once per
        solve."""
        inner = prep.inner if isinstance(prep, DeflatedPrep) else prep
        shape = _plane_shape(inner)
        if shape is not None:
            rhs = to_planes(rhs, *shape)
        if isinstance(prep, DeflatedPrep):
            res = self._solve_deflated(inner, prep.U, prep.Q, rhs,
                                       solver_cfg)
        else:
            res = self._solve_prepared_raw(prep, rhs, solver_cfg)
        if shape is None:
            return res
        return res._replace(x=from_planes(res.x, *shape))

    def _operators(self, prep: Prep) -> tuple:
        """(matvec, b_prep, the `HeldOperators` or None): held for the
        exact-Jacobian prep, built anew for any other (the Stokes operator,
        reference mode's per-iteration preps)."""
        if prep is not self._exact_prep:
            matvec, b_prep, _ = self._prep_operators(prep)
            return matvec, b_prep, None
        held, log = self._held, active()
        if held is None or held.prep is not prep or held.log is not log:
            matvec, b_prep, _ = self._prep_operators(prep)
            graphs = held.graphs if held and held.prep is prep else None
            held = self._held = HeldOperators(prep, log, matvec, b_prep,
                                              graphs)
        return held.matvec, held.b_prep, held

    def _iteration_graphs(self, held: Optional[HeldOperators], b,
                          solver_cfg):
        """The CUDA graphs of this solve's GMRES iterations where
        `graphs.engages` (a plain GMRES solve of the held prep on one CUDA
        tensor), else None."""
        if not krylov_graphs.engages(solver_cfg, held is not None, b):
            return None
        if held.graphs is None or not held.graphs.fits(b, solver_cfg.restart):
            held.graphs = krylov_graphs.IterationGraphs(b, solver_cfg.restart)
        return held.graphs

    def _solve_prepared_raw(self, prep: Prep, rhs: torch.Tensor,
                            solver_cfg) -> GMRESResult:
        matvec, b_prep, held = self._operators(prep)
        b_eff = b_prep(rhs)
        if solver_cfg.method == "cg":
            # for SPD sub-problems; the NS saddle-point system itself is
            # indefinite (use gmres)
            res = cg(matvec, b_eff, rtol=solver_cfg.rtol,
                     atol=solver_cfg.atol, maxiter=solver_cfg.maxiter)
            return GMRESResult(x=res.x, iters=res.iters,
                               resnorm=res.resnorm, converged=res.converged)
        if solver_cfg.method == "ca_gmres":
            # the Newton-basis shifts exist only for the constant exact
            # Jacobian (built in _ensure_prepared): the Stokes solve runs
            # before them and stays monomial, as in the JAX package
            shifts = self._ca_shifts if solver_cfg.ca_basis == "newton" \
                else None
            return ca_gmres(matvec, b_eff, basis=min(solver_cfg.restart, 16),
                            rtol=solver_cfg.rtol, atol=solver_cfg.atol,
                            maxiter=solver_cfg.maxiter, shifts=shifts)
        return gmres(matvec, b_eff, restart=solver_cfg.restart,
                     rtol=solver_cfg.rtol, atol=solver_cfg.atol,
                     maxiter=solver_cfg.maxiter,
                     cgs2_kernel=solver_cfg.cgs2 != "xla",
                     cgs2_compensated=solver_cfg.cgs2 == "pallas_comp",
                     graphs=self._iteration_graphs(held, b_eff, solver_cfg))

    # -- Krylov subspace recycling (solvers/deflation.py) ---------------------

    def _arnoldi_rhs(self, prep, ones_if_zero: bool) -> torch.Tensor:
        """The start vector of the preparation-time Arnoldi sweeps: the BC
        value vector on the prep's layout."""
        rhs = self.disc.bc.value.to(self.dtype)
        if ones_if_zero and not float(torch.linalg.norm(rhs)):
            rhs = torch.ones_like(rhs)
        shape = _plane_shape(prep)
        return rhs if shape is None else to_planes(rhs, *shape)

    def _build_deflation(self, prep) -> DeflatedPrep:
        """Wrap a prepared operator with a GCRO recycled pair: one m-step
        Arnoldi on the preconditioned operator (on the device), the
        harmonic Ritz extraction on the host, (U, Q) on the device."""
        cfgk = self.cfg.krylov
        rhs = self._arnoldi_rhs(prep, ones_if_zero=False)
        m = min(cfgk.deflation_arnoldi or max(3 * cfgk.deflation_k, 48),
                rhs.shape[0] - 2)
        k = min(cfgk.deflation_k, max(m - 2, 1))
        matvec, b_prep, _ = self._prep_operators(prep)
        V, H = arnoldi(matvec, b_prep(rhs), m)
        Y = torch.as_tensor(harmonic_ritz_basis(H.cpu().numpy(), k)).to(
            self.device, self.dtype)
        U, Q = recycle_space(V, H, Y)
        return DeflatedPrep(prep, U, Q)

    def _solve_deflated(self, prep, U: torch.Tensor, Q: torch.Tensor,
                        rhs: torch.Tensor, solver_cfg) -> GMRESResult:
        """GMRES in the orthogonal complement of the recycled space, then
        the exact correction of the recycled directions.  The inner
        residual is the true preconditioned residual, so the target is
        rtol * ||b_eff||, the undeflated norm, as in the plain solve: a
        target relative to ||r0|| = ||(I - Q Q^T) b_eff|| would be far
        stricter (the JAX package measured early steps running to maxiter,
        benchlogs/transient_scaling.txt)."""
        sc = self._sc
        matvec, b_prep, _ = self._prep_operators(prep)
        b_eff = b_prep(rhs)
        c0 = Q @ b_eff
        r0 = b_eff - Q.T @ c0

        def matvec_defl(x):
            w = matvec(x)
            return w - Q.T @ (Q @ w)

        b_norm = sc(fetch(torch.linalg.norm(b_eff)).item())
        res = gmres(matvec_defl, r0, restart=solver_cfg.restart, rtol=0.0,
                    atol=float(max(sc(solver_cfg.rtol) * b_norm,
                                   sc(solver_cfg.atol))),
                    maxiter=solver_cfg.maxiter,
                    cgs2_kernel=solver_cfg.cgs2 != "xla",
                    cgs2_compensated=solver_cfg.cgs2 == "pallas_comp")
        # x = y + U (Q^T (b - T y)): one more T apply per solve
        a = c0 - Q @ matvec(res.x)
        return res._replace(x=res.x + U.T @ a)

    def _build_ca_shifts(self, prep, s: int) -> tuple:
        """Leja-ordered Newton-basis shifts for ca_gmres: one m-step
        Arnoldi sweep on the preconditioned constant operator, Ritz values
        and Leja order on the host (`solvers/sstep.newton_shifts`)."""
        rhs = self._arnoldi_rhs(prep, ones_if_zero=True)
        m = min(max(2 * s, 32), rhs.shape[0] - 2)
        matvec, b_prep, _ = self._prep_operators(prep)
        _, H = arnoldi(matvec, b_prep(rhs), m)
        return newton_shifts(H.cpu().numpy(), s)

    # -- Stokes initialization -----------------------------------------------

    def _stokes_dia(self) -> torch.Tensor:
        """The BC-applied Stokes operator in DIA form (`:617-662`), at the
        small Stokes Reynolds number (`:1038`)."""
        stokes = self._assemble_dia(STOKES_TERMS, self.cfg.stokes_reynolds)
        return zero_rows_dia(self.disc.dia_pattern.offsets, stokes,
                             self.disc.bc.is_bc)

    @spanned("stokes")
    @no_tf32
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

    def _residual_fn(self, u_old: torch.Tensor):
        """u -> F(u): with residual='operator' A_lin u - (M/dt) u_old on
        the residual operators' layout ((M/dt) u_old is fixed for the step
        and applied once); otherwise the element-wise residual."""
        if self.cfg.residual != "operator":
            d, cfg = self.disc, self.cfg

            def element_residual(u):
                return assemble_residual(d.tets, d.vol, d.grad, d.h, u,
                                         u_old, cfg.dt, cfg.reynolds,
                                         cfg.delta, ndof=d.ndof)
            return element_residual
        res_A, res_M = self._res_A, self._res_M
        if self._plane:
            noffs, nb, nbp = self._noffs, self.disc.nv, self._nbp
            mass_uold = spmv_plane(noffs, res_M, to_planes(u_old, nb, nbp),
                                   nb=nb)

            def plane_residual(u):
                f = spmv_plane(noffs, res_A, to_planes(u, nb, nbp), nb=nb) \
                    - mass_uold
                return from_planes(f, nb, nbp)
            return plane_residual

        offs = self.disc.dia_pattern.offsets
        mass_uold = self._spmv(offs, res_M, u_old)

        def scalar_residual(u):
            return self._spmv(offs, res_A, u) - mass_uold
        return scalar_residual

    def _reference_jacobian(self, u: torch.Tensor) -> torch.Tensor:
        """jacobian='reference': J = J_linear + the convection terms at u
        in DIA form, BC rows zeroed."""
        UL, _ = local_fields(self.disc.tets, u)
        jnl = self._assemble_dia(NONLINEAR_TERMS, self.cfg.reynolds, UL=UL)
        return zero_rows_dia(self.disc.dia_pattern.offsets, self._jlin + jnl,
                             self.disc.bc.is_bc)

    def _newton_step(self, u_init, u_old, delta_u_init):
        cfg, nw, sc = self.cfg, self.cfg.newton, self._sc
        dtype = self.dtype
        is_bc = self.disc.bc.is_bc
        bc_value = self.disc.bc.value.to(dtype)
        zero = torch.zeros((), dtype=dtype, device=self.device)
        max_newton = nw.max_iter
        residual = self._residual_fn(u_old.to(dtype).contiguous())

        @wrap("newton.check")
        def check(u, delta_u):
            """BC insert + residual + the two norms (one host sync)."""
            u = torch.where(is_bc, bc_value, u)
            F = torch.where(is_bc, zero, residual(u))
            norms = fetch(torch.stack([torch.linalg.norm(F),
                                       torch.linalg.norm(delta_u)])).numpy()
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
            if self._reference:
                with span("newton.jacobian"):
                    jac = self._reference_jacobian(u)
                with span("newton.prep"):
                    prep = self._prepare_operator_dia(jac)
            else:
                prep = self._exact_prep
            sol = self._solve_prepared(prep, -F, cfg.krylov)
            u, delta_u = u + sol.x, sol.x
            lin_total += sol.iters
            u, F, rn, dn = check(u, delta_u)
            it += 1
            if it < max_newton:
                res_h[it], du_h[it] = rn, dn
            converged = bool(((rn < rtol * rn0) or (rn < atol))
                             and (dn < du_tol))
            # stagnation: tiny update, or (f32 only) no residual progress;
            # in float64 reference mode Newton is a fixed-point iteration
            # whose progress may be slower than 10% per iteration
            stagnated = bool(it > 5 and dn < sc(nw.stol))
            if dtype == torch.float32:
                stagnated = stagnated or bool(it > 2
                                              and rn >= sc(0.9) * prev_rn)
        stats = NewtonStats(iters=min(it + 1, max_newton),
                            converged=converged, res_hist=res_h,
                            du_hist=du_h, lin_iters=lin_total)
        return u, delta_u, stats

    @spanned("step")
    @no_tf32
    def step(self, u, u_old, delta_u):
        """One backward-Euler step. Returns (u_new, delta_u, stats)."""
        self._ensure_prepared()
        return self._newton_step(u, u_old, delta_u)

    # -- Time loop -----------------------------------------------------------

    @no_tf32
    def run(self, n_steps: Optional[int] = None, *, u0=None,
            save_dir: Optional[str] = None, save_every: Optional[int] = None,
            write_vtu_files: bool = False, monitor: bool = True,
            checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
            start_step: int = 0, delta_u0=None) -> torch.Tensor:
        """Transient run mirroring the reference CLI (`-save` writes
        `solution_stepNNNN.dat` per saved step; `write_vtu_files` adds
        `solution_NNNN.vtu` and, at the end, `time_series.pvd`).  Each
        step's stats and wall seconds (measured after a device sync) go to
        `self.history`.

        Resume, as in the JAX package: `start_step` goes on with the global
        step numbering of the files and checkpoints, and `delta_u0` starts
        the first Newton solve, so a resumed run repeats the uninterrupted
        one bit for bit.  A checkpoint at the end of step N (every
        `checkpoint_every` steps) holds the state the next step starts
        from (u_old = u) and the fingerprint of the user-level config."""
        cfg = self.cfg
        n_steps = cfg.n_steps if n_steps is None else n_steps
        save_every = cfg.save_every if save_every is None else save_every
        if u0 is None:
            u0 = self.stokes_init()
        u = torch.as_tensor(u0).to(self.device, self.dtype)
        u_old = u
        delta_u = torch.zeros_like(u) if delta_u0 is None else \
            torch.as_tensor(delta_u0).to(self.device, self.dtype)
        pvd_entries = []
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)

        for step in range(start_step + 1, start_step + n_steps + 1):
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
                if write_vtu_files:
                    vtu = f"solution_{step:04d}.vtu"
                    write_vtu(os.path.join(save_dir, vtu), self.disc.mesh, u)
                    pvd_entries.append((step, vtu))
            if checkpoint_path and checkpoint_every and \
                    step % checkpoint_every == 0:
                save_checkpoint(checkpoint_path, cfg=self.user_cfg,
                                step=step, u=u, u_old=u, delta_u=delta_u)
            u_old = u
        if save_dir and pvd_entries:
            write_pvd(os.path.join(save_dir, "time_series.pvd"), pvd_entries)
        return u
