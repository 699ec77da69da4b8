"""The Navier–Stokes solver row-partitioned over a list of devices: the JAX
package's `parallel/distributed.py` in one process.

`DistributedNavierStokesSolver` extends the single-device solver.  The
band-ordered mesh's rows are cut into one shard per entry of `devices`;
a device may repeat (`[cuda:0] * 4` runs four shards on one card, the
counterpart of the JAX package's virtual CPU devices).  What is
distributed, as in the JAX package:

- every assembly (Stokes, J_linear, the mass operator, the reference
  Jacobian's convection terms): each shard assembles its own elements
  (`partitioned_assemble_dia`), and the global (K, ndof) view is the
  shards side by side, on the first device;
- every Krylov solve: the prepared operator is cut into shards, vectors are
  `Shards`, each operator apply is one halo exchange and one launch per
  shard of K1 ('tlp') or K2 ('tl', 'bj') in its ghost-row form, the coarse
  correction restricts per shard, gathers the coarse residual onto every
  device and applies the dense inverse row-sharded (or the multilevel cycle
  replicated per device), and GMRES's inner products are fixed-order sums
  over the shards (`solvers/vectors.py`);
- the operator-form residual, through the same partitioned applies.

The preparation between assembly and solve (D^{-1}, the coarse level, the
plane extraction) runs in the global view on the first device, as the JAX
package runs it unsharded.  Vectors are joined only at the boundary of a
solve (the right-hand side in, the update out) and of a residual.

Per-shard layout: L scalar rows (or Lb nodes on the plane layout) per
shard, at least the operator's halo; on 'tl' L is a multiple of 4 * agg
and on 'tlp' Lb of agg (and of a 16-byte unit), so every aggregate lives
on one shard; padding rows are exact zeros.  The JAX package's TPU
granule and tile rounding is not carried.

Refused, as in the JAX package: preconditioner='schur', deflation,
coarse_cheby and coarse_basis='linear'.  Refused where the JAX package
would silently substitute: cgs2='pallas'|'pallas_comp' (the JAX package
falls back to its XLA GEMVs with a warning; a fused K3 launch cannot hold a
sum across shards), method='cg' (it runs GMRES), ca_basis='newton' (it
drops the shifts) and coarse_smooth_omega (it applies the plain
prolongator).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from navierstokes_tpu_torch.config import NSConfig
from navierstokes_tpu_torch.mesh.core import Mesh
from navierstokes_tpu_torch.mesh.ordering import best_ordering, reorder_mesh
from navierstokes_tpu_torch.model.navier_stokes import (
    DINV_OFFSETS,
    BlockJacobiPrep,
    DenseCoarse,
    MultilevelCoarse,
    NavierStokesSolver,
    PlanePrep,
    ScalarTwoLevelPrep,
)
from navierstokes_tpu_torch.ops.plane_dia import (
    extract_planes,
    from_planes,
    to_planes,
)
from navierstokes_tpu_torch.parallel.partitioned import (
    all_gather,
    build_element_partition,
    halo_of,
    join_rows,
    partitioned_assemble_dia,
    partitioned_spmv_dia,
    partitioned_spmv_dia_power,
    partitioned_spmv_plane,
    plane_shard_nodes,
    scalar_shard_rows,
    shard_element_arrays,
    shard_rows,
    split_rows,
)
from navierstokes_tpu_torch.solvers.coarse import CoarseSpace
from navierstokes_tpu_torch.solvers.gmres import GMRESResult, gmres
from navierstokes_tpu_torch.solvers.sstep import ca_gmres
from navierstokes_tpu_torch.solvers.vectors import Shards
from navierstokes_tpu_torch.utils.precision import no_tf32, no_tf32_operators

SCHUR_SINGLE_CHIP = ("preconditioner='schur' is single-chip only (its "
                     "sub-block plane applies are not sharded); use "
                     "'two_level'")
LINEAR_SINGLE_CHIP = ("coarse_basis='linear' is single-chip only (its "
                      "weighted restriction is not implemented per shard; "
                      "it is also a measured loss at scale — "
                      "benchlogs/transient_scaling.txt)")


@dataclasses.dataclass
class ShardedCoarse:
    """The coarse level under distribution: the dense inverse padded to
    nc_pad and cut by rows (`rows`: shard s holds the rows of its own
    aggregates), or the multilevel level replicated on every device
    (`replicas`: device -> MultilevelCoarse)."""

    nc: int
    nc_pad: int
    rows: Optional[Shards] = None
    replicas: Optional[dict] = None


@dataclasses.dataclass
class ShardedPrep:
    """A prepared operator ('tlp', 'tl' or 'bj') cut into row shards: the
    operator (plane (n_out, 4 N_D, Lb) or DIA (K, L) data), D^{-1} (the
    (16, Lb) planes or the 7-diagonal DIA data), the coarse level, and
    L rows (nodes on 'tlp') per shard of the n live ones."""

    kind: str
    offsets: tuple              # node offsets ('tlp'), else scalar offsets
    op: Shards
    dinv: Shards
    coarse: Optional[ShardedCoarse]
    cs: Optional[CoarseSpace]
    L: int
    n: int


class Layout(NamedTuple):
    """How a global vector is cut: 'tlp' plane-major by Lb = L nodes per
    shard, else interleaved by L scalar rows; n live nodes or rows."""

    kind: str
    L: int
    n: int


def _normal(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class DistributedNavierStokesSolver(NavierStokesSolver):
    """The transient solve with every assembly and every Krylov solve
    row-partitioned over `devices` (one shard each; see the module
    docstring).  The mesh must be band-ordered so that the band fits a
    shard: `from_mesh` orders it."""

    _auto_single_chip = False
    _supports_cheby = False
    _supports_deflation = False

    def __init__(self, mesh: Mesh, cfg: Optional[NSConfig] = None,
                 disc=None, *, devices):
        if cfg is not None and cfg.krylov.preconditioner == "schur":
            raise ValueError(SCHUR_SINGLE_CHIP)
        self.devices = [_normal(d) for d in devices]
        if not self.devices:
            raise ValueError("devices: at least one")
        self.n_devices = len(self.devices)
        super().__init__(mesh, cfg, disc, device=self.devices[0])
        self._refuse_unsupported()
        d = self.disc
        halo = max(abs(o) for o in d.dia_pattern.scaled_offsets)
        L = -(-d.ndof // self.n_devices)
        if halo > L:
            raise ValueError(
                f"scalar bandwidth {halo} exceeds rows-per-device {L}; "
                "reduce device count or refine/reorder the mesh")
        self._epart = build_element_partition(
            d.tets.cpu().numpy(), d.dia_elem_map.cpu().numpy(), d.ndof,
            d.dia_pattern.K, halo_of(d.dia_pattern.offsets), self.n_devices)
        self._ep_arrays = shard_element_arrays(self._epart, d.vol, d.grad,
                                               d.h, self.devices)

    @classmethod
    def from_mesh(cls, mesh: Mesh, cfg: Optional[NSConfig] = None, *,
                  devices):
        """Band-order the mesh (`best_ordering`), then build the solver;
        returns (solver, perm) with perm[new] = old node."""
        perm = best_ordering(mesh)
        return cls(reorder_mesh(mesh, perm), cfg, devices=devices), perm

    def _refuse_unsupported(self) -> None:
        for sc in (self.cfg.krylov, self.cfg.stokes_krylov):
            if sc.cgs2 != "xla":
                raise ValueError(
                    f"cgs2={sc.cgs2!r} is single-device only: the fused "
                    "CGS2 projection (K3) is one launch over the whole "
                    "basis and cannot sum its inner products across "
                    "shards; use cgs2='xla'")
            if sc.method == "cg":
                raise ValueError(
                    "method='cg' is single-device only: the JAX package's "
                    "distributed solver runs GMRES under this name")
            if sc.method == "ca_gmres" and sc.ca_basis == "newton":
                raise ValueError(
                    "ca_basis='newton' is single-device only: the JAX "
                    "package's distributed solve drops the shifts and runs "
                    "the monomial basis")
        kr = self.cfg.krylov
        if kr.coarse_basis == "linear":
            raise ValueError(LINEAR_SINGLE_CHIP)
        if kr.coarse_smooth_omega:
            raise ValueError(
                "coarse_smooth_omega is single-device only: the JAX "
                "package's distributed solve applies the plain prolongator "
                "with the smoothed coarse inverse")

    # -- layout ---------------------------------------------------------------

    def placement(self) -> str:
        cards = len(dict.fromkeys(self.devices))
        return (f"{self.n_devices} shards on {cards} device(s): "
                + ", ".join(str(d) for d in self.devices))

    def _plane_nbp(self) -> int:
        """P * Lb (`plane_shard_nodes`)."""
        itemsize = torch.tensor([], dtype=self.dtype).element_size()
        return self.n_devices * plane_shard_nodes(
            self.disc.nv, self._noffs, self.n_devices,
            self.cfg.krylov.coarse_agg, itemsize)

    def _scalar_rows(self, offsets: tuple) -> int:
        """L (`scalar_shard_rows`), a multiple of 4 * agg on 'tl'."""
        m = 4 * self.cfg.krylov.coarse_agg if self.prep_kind == "tl" else 1
        return scalar_shard_rows(self.disc.ndof, offsets, self.n_devices, m)

    def _split(self, layout, x: torch.Tensor) -> Shards:
        """An interleaved global vector into the shards of `layout` (a
        `Layout` or a `ShardedPrep`)."""
        if layout.kind == "tlp":
            nbp = layout.L * self.n_devices
            planes = to_planes(x, layout.n, nbp).reshape(4, nbp)
            v = split_rows(planes, layout.L, self.devices)
            return Shards(a.reshape(-1) for a in v.parts)
        return split_rows(x, layout.L, self.devices)

    def _join(self, layout, v: Shards) -> torch.Tensor:
        if layout.kind == "tlp":
            nbp = layout.L * self.n_devices
            planes = join_rows(Shards(a.reshape(4, -1) for a in v.parts),
                               nbp, self.device)
            return from_planes(planes.reshape(-1), layout.n, nbp)
        return join_rows(v, layout.n, self.device)

    def shard_kernel_name(self) -> str:
        """The kernel form each shard's operator apply launches: K1's or
        K2's ghost-row form (`_plain` where spmv='xla' runs K2's plain
        version)."""
        if self.prep_kind == "tlp":
            return "plane_spmv_halo"
        return "dia_spmv_halo" + ("_plain" if self.cfg.krylov.spmv == "xla"
                                  else "")

    # -- assembly: per shard ----------------------------------------------

    def _assemble_dia(self, terms, reynolds: float,
                      UL: Optional[torch.Tensor] = None) -> torch.Tensor:
        parts = partitioned_assemble_dia(
            self._epart, self._ep_arrays, self.cfg.dt, reynolds,
            self.cfg.delta, terms=terms, UL=UL)
        return join_rows(parts, self.disc.ndof, self.device)

    def release_assembly_buffers(self) -> None:
        super().release_assembly_buffers()
        self._ep_arrays = None

    # -- preparation: global view, then shards ------------------------------

    def _prepare_operator_dia(self, dia_data: torch.Tensor) -> ShardedPrep:
        prep = super()._prepare_operator_dia(dia_data)
        devs = self.devices
        if isinstance(prep, PlanePrep):
            Lb = prep.nbp // self.n_devices
            return ShardedPrep(
                "tlp", prep.node_offsets, split_rows(prep.p4, Lb, devs),
                split_rows(prep.d16, Lb, devs),
                self._shard_coarse(prep.coarse, 4 * prep.nbp // prep.cs.
                                   agg_size), prep.cs, Lb, prep.nb)
        if isinstance(prep, ScalarTwoLevelPrep):
            L = self._scalar_rows(prep.offsets)
            return ShardedPrep(
                "tl", prep.offsets, split_rows(prep.data, L, devs),
                split_rows(prep.invd, L, devs),
                self._shard_coarse(prep.coarse, self.n_devices * L
                                   // prep.cs.agg_size), prep.cs, L,
                self.disc.ndof)
        assert isinstance(prep, BlockJacobiPrep), prep
        L = self._scalar_rows(prep.s_offsets)
        return ShardedPrep("bj", prep.s_offsets,
                           split_rows(prep.s_data, L, devs),
                           split_rows(prep.invd, L, devs), None, None, L,
                           self.disc.ndof)

    def _shard_coarse(self, coarse, nc_pad: int) -> ShardedCoarse:
        if isinstance(coarse, DenseCoarse):
            nc = coarse.ac_inv.shape[0]
            acp = torch.zeros((nc_pad, nc_pad), dtype=coarse.ac_inv.dtype,
                              device=coarse.ac_inv.device)
            acp[:nc, :nc] = coarse.ac_inv
            c = nc_pad // self.n_devices
            return ShardedCoarse(nc, nc_pad, rows=Shards(
                acp[s * c:(s + 1) * c].to(dev)
                for s, dev in enumerate(self.devices)))
        assert isinstance(coarse, MultilevelCoarse), coarse
        return ShardedCoarse(coarse.ac1.shape[1], nc_pad, replicas={
            dev: MultilevelCoarse(coarse.offsets, coarse.ac1.to(dev),
                                  coarse.invd1.to(dev), coarse.cs2,
                                  coarse.ac2_inv.to(dev))
            for dev in dict.fromkeys(self.devices)})

    # -- applies on shards ----------------------------------------------------

    @no_tf32_operators
    def _prep_operators(self, prep: ShardedPrep):
        """(matvec, b_prep, parts) on shards, the distributed counterpart
        of the single-device operators with the same algebra: 'bj' the
        Neumann-boosted S, 'tl' and 'tlp' the two-grid cycle (coarse
        correction, then one Jacobi application)."""
        plain = self.cfg.krylov.spmv == "xla"
        if prep.kind == "tlp":
            d3 = [d.reshape(4, 4, prep.L) for d in prep.dinv.parts]

            def apply_A(x):
                return partitioned_spmv_plane(prep.offsets, prep.op, x,
                                              nb=prep.n)

            def apply_Dinv(r):
                # block-diagonal D^{-1}: 16 elementwise plane multiplies
                return Shards((d * v.reshape(1, 4, -1)).sum(1).reshape(-1)
                              for d, v in zip(d3, r.parts))
        else:
            def apply_A(x):
                return partitioned_spmv_dia(prep.offsets, prep.op, x,
                                            plain=plain)

            def apply_Dinv(r):
                return partitioned_spmv_dia(DINV_OFFSETS, prep.dinv, r,
                                            plain=plain)

        if prep.kind == "bj":
            order = self.cfg.krylov.neumann_order

            def neumann(r):
                acc = r
                cur = r
                for _ in range(order):
                    cur = cur - apply_A(cur)
                    acc = acc + cur
                return acc

            def matvec(x):
                return neumann(apply_A(x))

            def b_prep(rhs):
                return neumann(apply_Dinv(rhs))

            return matvec, b_prep, {"apply_S": apply_A, "neumann": neumann}

        coarse = self._coarse_correction(prep)

        def minv(r):
            z = coarse(r)
            return z + apply_Dinv(r - apply_A(z))

        def matvec(x):
            return minv(apply_A(x))

        return matvec, minv, {"apply_A": apply_A, "apply_Dinv": apply_Dinv,
                              "coarse": coarse, "minv": minv}

    def _coarse_correction(self, prep: ShardedPrep):
        """r -> P A_c^{-1} R r on shards: each shard sums its own
        aggregates, the coarse residual is gathered onto every device, the
        dense inverse's row block (or the replicated multilevel cycle)
        gives the shard's own coarse values, broadcast back to its rows;
        padding rows stay exact zeros."""
        agg, c = prep.cs.agg_size, prep.coarse
        P, plane = self.n_devices, prep.kind == "tlp"
        live = shard_rows(prep.n, prep.L, P)
        chunk = c.nc_pad // P
        solves = {} if c.replicas is None else {
            dev: self._make_coarse_solve(rep)
            for dev, rep in c.replicas.items()}

        def restrict(r):
            if plane:               # coarse dof 4g + c of aggregate g
                return r.reshape(4, -1, agg).sum(-1).T.reshape(-1)
            return r.reshape(-1, agg, 4).sum(1).reshape(-1)

        def prolong(zc, n):
            if plane:
                z = zc.reshape(-1, 4).T.repeat_interleave(agg, dim=1)
                z[:, n:] = 0
            else:
                z = zc.reshape(-1, 1, 4).expand(-1, agg, 4).reshape(-1)
                z[n:] = 0
            return z.reshape(-1)

        def coarse(r):
            rcs = [restrict(a) for a in r.parts]
            rc = {dev: all_gather(rcs, dev) for dev in dict.fromkeys(
                self.devices)}
            if c.rows is not None:
                zcs = [rows @ rc[dev] for rows, dev in
                       zip(c.rows.parts, self.devices)]
            else:
                full = {dev: torch.nn.functional.pad(
                    solve(rc[dev][:c.nc]), (0, c.nc_pad - c.nc))
                    for dev, solve in solves.items()}
                zcs = [full[dev][s * chunk:(s + 1) * chunk]
                       for s, dev in enumerate(self.devices)]
            return Shards(prolong(zc, n) for zc, n in zip(zcs, live))

        return coarse

    @no_tf32
    def _solve_prepared(self, prep: ShardedPrep, rhs: torch.Tensor,
                        solver_cfg) -> GMRESResult:
        """The solve on shards: rhs in, the update out; CA-GMRES on 'bj'
        without the Neumann boost takes its basis from the one-exchange
        power sweep where basis * h fits a shard."""
        matvec, b_prep, _ = self._prep_operators(prep)
        b_eff = b_prep(self._split(prep, rhs))
        if solver_cfg.method == "ca_gmres":
            basis = min(solver_cfg.restart, 16)
            powers_fn = None
            if prep.kind == "bj" and self.cfg.krylov.neumann_order == 0 \
                    and basis * halo_of(prep.offsets) <= prep.L:
                plain = self.cfg.krylov.spmv == "xla"

                def powers_fn(v, s):
                    return partitioned_spmv_dia_power(
                        prep.offsets, prep.op, v, s, return_all=True,
                        plain=plain)
            res = ca_gmres(matvec, b_eff, basis=basis, rtol=solver_cfg.rtol,
                           atol=solver_cfg.atol, maxiter=solver_cfg.maxiter,
                           powers_fn=powers_fn)
        else:
            res = gmres(matvec, b_eff, restart=solver_cfg.restart,
                        rtol=solver_cfg.rtol, atol=solver_cfg.atol,
                        maxiter=solver_cfg.maxiter)
        return res._replace(x=self._join(prep, res.x))

    # -- the operator-form residual on shards -------------------------------

    def _residual_operators(self, prep, jlin: torch.Tensor) -> tuple:
        """(A_lin, M/dt) in shards of the solve's layout; A_lin is the
        prep's own operator where it differs only in BC rows, as on one
        device."""
        offs = self.disc.dia_pattern.offsets
        mass = self._assemble_dia(frozenset({"mass_dt_bare"}),
                                  self.cfg.reynolds)
        if self._plane:
            Lb = self._nbp // self.n_devices

            def planes(data):
                return split_rows(extract_planes(
                    offs, data, self.disc.nv, node_offsets=self._noffs,
                    nbp=self._nbp), Lb, self.devices)
            return (prep.op if prep is not None else planes(jlin),
                    planes(mass))
        self._res_L = self._scalar_rows(offs) if prep is None else prep.L
        share = prep is not None and prep.kind == "tl" and \
            self.cfg.krylov.matvec_dtype is None
        return (prep.op if share else split_rows(jlin, self._res_L,
                                                 self.devices),
                split_rows(mass, self._res_L, self.devices))

    def _residual_fn(self, u_old: torch.Tensor):
        if self.cfg.residual != "operator":
            return super()._residual_fn(u_old)
        res_A, res_M = self._res_A, self._res_M
        if self._plane:
            layout = Layout("tlp", self._nbp // self.n_devices, self.disc.nv)

            def apply(data, x):
                return partitioned_spmv_plane(self._noffs, data, x,
                                              nb=self.disc.nv)
        else:
            offs = self.disc.dia_pattern.offsets
            plain = self.cfg.krylov.spmv == "xla"
            layout = Layout("scalar", self._res_L, self.disc.ndof)

            def apply(data, x):
                return partitioned_spmv_dia(offs, data, x, plain=plain)
        mass_uold = apply(res_M, self._split(layout, u_old))

        def residual(u):
            return self._join(layout,
                              apply(res_A, self._split(layout, u))
                              - mass_uold)
        return residual
