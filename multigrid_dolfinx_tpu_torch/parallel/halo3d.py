"""The distributed 3D z-slab solve over torch.distributed.

Mirrors `multigrid_dolfinx_tpu.parallel.halo3d` for constant-coefficient
P1 in 3D.  Every rank holds a z-slab of every level at or above
`shard_from` (the plan of `pick_z_shard_plan`: z padded to a multiple of
4 ngz that doubles up the levels); the levels below are replicated, and
every rank runs them redundantly with the single-device code
(`solver.vcycle.tail_or_recurse`, the fused tail K13/K14 included).

On a sharded level a V-cycle runs ν1 sweeps (K25 red-black with 2-deep
halos, K26 Jacobi with 1-deep halos, or Chebyshev in the momentum form
of `ops.smoothers.chebyshev_phase` on the residual K27), the fused
residual + P^T restriction K28 (for injection: K27 and a strided copy),
the recursion, the prolongation + correction K29 and ν2 sweeps.  Going
down into the replicated levels each rank restricts its slab first and
then all-gathers the 8x smaller coarse grid; going up, each rank
prolongs the replicated grid (K3), cuts its slab and adds it.  The check
after each cycle is the FEM-L2 class-table mass quadratic form of the
residual with a 1-deep halo, one f64 partial per rank, summed in rank
order on every rank (`SlabComm.sum_scalar`); MG-CG's dots are summed the
same way, and its A p is -r(p, 0) (`solver.krylov.apply_operator`'s
repair of the JAX package's p - r(p, p)).  Each point of a sharded
kernel keeps the single-device association, so the gathered V-cycle
iterate is bitwise the single-device one.

Entry points (each called on every rank after `init_process_group`;
`device` defaults to the CUDA card): `build_halo_solver3d` (FMG + the
tolerance loop), `build_halo_cycler3d` (k chained V-cycles),
`build_halo_mgcg3d` (flexible MG-CG from an FMG start),
`build_halo_resume3d` (the tolerance loop from (v0, k0, hist0)),
`make_distributed_rb_smoother`, `make_distributed_jacobi_smoother`,
`halo_extend_z` and `gather_solution`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import CycleSpec, SolverConfig
from ..mesh import build_grid_hierarchy
from ..ops import dispatch
from ..ops.cuda.stencil3d_dist import slab_coords, slab_interior
from ..ops.operators import axis_class
from ..ops.smoothers import NP_TYPES, cheby_phase, cheby_window
from ..solver.fmg import SolveResult
from ..solver.hierarchy import (Hierarchy, Level, build_lean_hierarchy,
                                check_problem)
from ..solver.krylov import CGResult
from ..solver.vcycle import prolong_level, tail_or_recurse
from ..solver.vcycle import vcycle as vcycle_replicated
from .comm import SlabComm


# ----------------------------------------------------------------------
# The plan
# ----------------------------------------------------------------------

def pick_z_shard_plan(config: SolverConfig, ngz: int, min_slab: int = 2,
                      align: bool = True):
    """(plan, shard_from) for slabs along the leading axis over `ngz`
    ranks (the JAX package's pick_z_shard_plan with ngz for its mesh), in
    the problem's dimension: z-slabs in 3D, row strips in 2D
    (parallel.halo.pick_shard_pad_plan).  Levels from shard_from up get
    (z, m, ...): z padded to a mesh-divisible size that doubles up the
    levels, so transfers stay slab-local; coarser levels stay replicated.
    Level 0 never shards (the coarse solve needs the whole grid).

    align=True: z is rounded to the quantum 4 ngz, so every rank's slab
    count is a multiple of 4 and every z_base even; shard_from minimises
    the finest level's padded z, near-ties going to more sharded levels;
    replicated levels get (m, m, ...).  align=False: the first level with
    >= min_slab ngz points shards, z rounded to ngz; replicated levels
    get None.  Storage is unpadded past the leading axis (no TPU tile
    rounding)."""
    ndim = config.problem.ndim
    grids = build_grid_hierarchy(config.hierarchy, ndim=ndim)
    lms = [g.points_per_dim for g in grids]
    L = len(lms) - 1
    valid = [i for i in range(1, len(lms)) if lms[i] >= min_slab * ngz]
    if not valid:
        raise ValueError(
            f"no level large enough to z-shard over {ngz} ranks "
            f"(finest has {lms[-1]} points/dim)")
    if align:
        q = 4 * ngz

        def zfin(si):
            return ((lms[si] + q - 1) // q) * q * (2 ** (L - si))

        zmin = min(zfin(si) for si in valid)
        shard_from = min(
            si for si in valid if zfin(si) - zmin <= max(zmin // 16, q))
        z0 = ((lms[shard_from] + q - 1) // q) * q
        plan = [(m,) * ndim if i < shard_from
                else (z0 * 2 ** (i - shard_from),) + (m,) * (ndim - 1)
                for i, m in enumerate(lms)]
        return plan, shard_from
    shard_from = valid[0]
    z0 = ((lms[shard_from] + ngz - 1) // ngz) * ngz
    plan = [None if i < shard_from
            else (z0 * 2 ** (i - shard_from),) + (m,) * (ndim - 1)
            for i, m in enumerate(lms)]
    return plan, shard_from


@dataclasses.dataclass(frozen=True)
class ZPlan:
    """Points per axis of each level, the padded z of each sharded level
    (None below shard_from) and the rank count."""

    lms: Tuple[int, ...]
    zs: Tuple[Optional[int], ...]
    shard_from: int
    ngz: int

    @classmethod
    def of(cls, config: SolverConfig, ngz: int) -> "ZPlan":
        plan, s = pick_z_shard_plan(config, ngz, align=True)
        return cls(lms=tuple(p[1] for p in plan),
                   zs=tuple(p[0] if i >= s else None
                            for i, p in enumerate(plan)),
                   shard_from=s, ngz=ngz)

    def mz(self, li: int) -> int:
        """Slabs per rank of sharded level li."""
        return self.zs[li] // self.ngz


def cut_slab(full: torch.Tensor, mz: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s (mz, ...) z-slab of a logical level, zero where it
    passes the level's last plane (plan padding)."""
    out = torch.zeros((mz,) + tuple(full.shape[1:]), dtype=full.dtype,
                      device=full.device)
    lo = rank * mz
    hi = min(lo + mz, full.shape[0])
    if hi > lo:
        out[:hi - lo] = full[lo:hi]
    return out


# ----------------------------------------------------------------------
# A rank's levels
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloHierarchy:
    """A rank's levels: `local` is the port's lean Hierarchy (coarse
    factor, the finest level's class-table mass and error quadrature) in
    which b and g of every level from plan.shard_from up are the rank's
    (mz, lm, lm) slab in 3D, its (mz, lm) row strip in 2D (padding rows
    0); each level's operator is the const-7 (const-5) of the whole
    level.  The single-device cycle runs the whole levels below
    shard_from from `local` as it stands."""

    plan: ZPlan
    rank: int
    local: Hierarchy

    @property
    def levels(self) -> Tuple[Level, ...]:
        return self.local.levels

    @property
    def num_levels(self) -> int:
        return self.local.num_levels

    @property
    def finest(self) -> Level:
        return self.local.finest

    def z_base(self, li: int) -> int:
        """Global z of local slab 0 on sharded level li."""
        return self.rank * self.plan.mz(li)


def check_halo_cycle(spec: CycleSpec) -> None:
    """Raise for the cycle options the distributed cycles (3D z-slabs and
    2D row strips) do not run yet, naming the ROADMAP.md item that brings
    each; the single-device cycle runs them all."""
    if spec.cycle != "V":
        raise NotImplementedError(
            f"distributed {spec.cycle}-cycles are ROADMAP.md queue 1, item 8")
    if spec.restriction == "full_weighting" or spec.prolongation != "bilinear":
        raise NotImplementedError(
            "distributed 'full_weighting' restriction and 'p1' "
            "prolongation are ROADMAP.md queue 1, item 5")
    if spec.fusion:
        raise NotImplementedError(
            "the distributed cycles have no fused kernels: CycleSpec.fusion "
            "runs on the single-device cycle")


def check_halo_config(config: SolverConfig) -> None:
    """Raise for problems and cycle options outside the distributed 3D
    slice, naming the ROADMAP.md item that brings each."""
    p = config.problem
    if p.ndim != 3:
        raise NotImplementedError(
            "the distributed 2D row-strip solve is parallel.halo."
            "build_halo_solver (and build_halo_cycler)")
    if p.degree != 1:
        raise NotImplementedError(
            "distributed P2 (parallel/halo3d_p2.py) is ROADMAP.md queue 1, "
            "item 18")
    if p.kappa is not None:
        raise NotImplementedError(
            "distributed variable kappa (parallel/halo3d_var.py) is "
            "ROADMAP.md queue 1, item 18")
    check_problem(config)
    check_halo_cycle(config.cycle)


def build_halo_hierarchy(config: SolverConfig, comm: SlabComm,
                         device="cuda") -> HaloHierarchy:
    """This rank's levels on `device`: solver.hierarchy's lean build, each
    sharded level's b and g built whole (fem.fast_const.
    device_level_arrays) and cut to the rank's slab at once, so the slab
    equals the single-device build's rows bitwise and the whole level is
    freed before the next is built."""
    check_halo_config(config)
    return slab_hierarchy(config, comm, device)


def slab_hierarchy(config: SolverConfig, comm: SlabComm,
                   device) -> HaloHierarchy:
    """The lean build with each sharded level's b and g cut to the rank's
    slab along the leading axis (z-slabs in 3D, row strips in 2D); the
    caller has checked the configuration."""
    plan = ZPlan.of(config, comm.size)

    def cut(li, a):
        if li < plan.shard_from:
            return a
        return cut_slab(a, plan.mz(li), comm.rank)

    return HaloHierarchy(plan=plan, rank=comm.rank,
                         local=build_lean_hierarchy(config, device, cut=cut))


# ----------------------------------------------------------------------
# The distributed cycle
# ----------------------------------------------------------------------

def _weights(level: Level):
    return dispatch.const7_weights(level.A)


class _HaloOps:
    """The per-rank operations of the distributed cycle (the JAX
    package's make_local_ops)."""

    def __init__(self, hier: HaloHierarchy, spec, comm: SlabComm):
        self.h, self.spec, self.comm = hier, spec, comm
        self.s = hier.plan.shard_from
        self.L = hier.num_levels - 1

    def lm(self, li):
        return self.h.plan.lms[li]

    # -- sharded-level kernels ----------------------------------------
    # fh: f's 2-deep halos, exchanged once a V-cycle level (f does not
    # change there); None makes each call exchange its own.
    @staticmethod
    def _cut(fh, depth):
        lo, hi = fh
        return lo[2 - depth:].contiguous(), hi[:depth].contiguous()

    def residual(self, li, v, f, fh=None):
        """r = f - A v on the rank's slab (K27)."""
        wc, woff = _weights(self.h.levels[li])
        if fh is None:
            vlo, vhi, flo, fhi = self.comm.halos2(v, f, 1)
        else:
            (vlo, vhi), (flo, fhi) = self.comm.halos(v, 1), self._cut(fh, 1)
        return dispatch.residual_dist(v, f, vlo, vhi, flo, fhi, self.lm(li),
                                      wc, woff, self.h.z_base(li))

    def smooth(self, li, v, f, n, fh):
        if n <= 0:
            return v
        lv = self.h.levels[li]
        wc, woff = _weights(lv)
        lm, zb = self.lm(li), self.h.z_base(li)
        kind = self.spec.smoother
        if kind == "chebyshev":
            return self._chebyshev(li, lv, v, f, n, fh)
        depth = 2 if kind == "rbgs" else 1
        flo, fhi = self._cut(fh, depth)
        for _ in range(n):
            vlo, vhi = self.comm.halos(v, depth)
            if kind == "jacobi":
                v = dispatch.jacobi_sweep_dist(v, f, vlo, vhi, flo, fhi, lm,
                                               wc, woff, lv.sm.omega, zb)
            else:
                v = dispatch.rb_sweep_dist(v, f, vlo, vhi, flo, fhi, lm, wc,
                                           woff, zb)
        return v

    def _chebyshev(self, li, lv, v, f, n, fh):
        """ops.smoothers.chebyshev_phase on the slab: each step
        (v + a (v - vp)) + b z, z = r (1/wc) inside and r on the boundary
        rows, r from K27 (K12's plain arithmetic)."""
        wc, _ = _weights(lv)
        interior = slab_interior(v.shape[0], self.lm(li), self.h.z_base(li),
                                 v.device)
        rounds, degree = cheby_phase(n, lv.sm.cheby_degree)
        theta, delta, sigma = cheby_window(lv.sm, v.dtype)
        one, two = type(theta)(1.0), type(theta)(2.0)

        def step(v, vp, a, b):
            r = self.residual(li, v, f, fh)
            z = torch.where(interior, r * (1.0 / wc), r)
            return (v + a * (v - vp)) + b * z

        for _ in range(rounds):
            vp = v
            v = step(v, v, 0.0, float(one / theta))
            rho_prev = one / sigma
            for _ in range(1, degree):
                rho = one / (two * sigma - rho_prev)
                vp, v = v, step(v, vp, float(rho * rho_prev),
                                float(two * rho / delta))
                rho_prev = rho
        return v

    def coarse_rhs(self, li, v, f, fh):
        """The level li-1 right-hand side: K28 (or K27 and injection) on
        the slab; into a replicated level, all-gathered and cropped."""
        lmc = self.lm(li - 1)
        if self.spec.restriction == "pt":
            wc, woff = _weights(self.h.levels[li])
            vlo, vhi = self.comm.halos(v, 2)
            fc = dispatch.restrict_residual_pt_dist(
                v, f, vlo, vhi, *fh, self.lm(li), lmc, wc, woff,
                self.h.z_base(li))
        else:
            fc = self.residual(li, v, f, fh)[::2, ::2, ::2].contiguous()
        if li - 1 >= self.s:
            return fc
        return self.comm.gather_z(fc)[:lmc].contiguous()

    def prolong(self, li, vc, v=None):
        """P(vc) on level li's slab, or v + P(vc): K29 between sharded
        levels; from the replicated level li-1, K3 on the whole grid,
        then the rank's slab."""
        if li - 1 >= self.s:
            chi = self.comm.shift_slabs(vc[:1], forward=False)
            return dispatch.prolong_linear_dist(vc, chi, self.lm(li),
                                                self.h.z_base(li), v)
        e = cut_slab(dispatch.prolong_linear(vc, self.lm(li)),
                     self.h.plan.mz(li), self.h.rank)
        return e if v is None else v + e

    # -- the cycle -----------------------------------------------------
    def vcycle(self, li, v, f):
        """One V-cycle at level li (sharded or replicated)."""
        if li < self.s:
            return vcycle_replicated(self.h.local, self.spec, li, v, f)
        spec = self.spec
        fh = self.comm.halos(f, 2)
        v = self.smooth(li, v, f, spec.nu1, fh)
        fc = self.coarse_rhs(li, v, f, fh)
        if li - 1 >= self.s:
            vc = self.vcycle(li - 1, torch.zeros_like(fc), fc)
        else:
            vc = tail_or_recurse(self.h.local, spec, li - 1, fc)
        v = self.prolong(li, vc, v)
        return self.smooth(li, v, f, spec.nu2, fh)

    def prolong_up(self, li, v):
        """The FMG ramp's prolongation into level li."""
        if li >= self.s:
            return self.prolong(li, v)
        return prolong_level(v, self.h.levels[li])

    def fmg_ramp(self, mu0, finest_cycles):
        """Nested iteration: the coarse solve, then on each finer level
        the prolonged iterate and mu0 V-cycles (on the finest only if
        finest_cycles)."""
        h = self.h
        v = h.local.coarse.solve(h.levels[0].b)
        for li in range(1, self.L + 1):
            v = self.prolong_up(li, v)
            if li == self.L and not finest_cycles:
                break
            for _ in range(mu0):
                v = self.vcycle(li, v, h.levels[li].b)
        return v

    # -- norms and dots ------------------------------------------------
    def mass_partial(self, r):
        """This rank's share of r^T M r (class-table mass, 1-deep halo),
        summed in f64."""
        M = self.h.local.M_fine
        lm = self.lm(self.L)
        zb = self.h.z_base(self.L)
        mz = r.shape[0]
        lo, hi = self.comm.halos(r, 1)
        up = torch.nn.functional.pad(torch.cat([lo, r, hi]), (1, 1, 1, 1))
        z, _, _ = slab_coords(mz, lm, zb, r.device)
        cz = torch.where(z == 0, 0, torch.where(z == lm - 1, 2, 1))
        cyx = axis_class(lm, lm, r.device)
        cls = (cz * 3 + cyx.view(1, -1, 1)) * 3 + cyx.view(1, 1, -1)
        acc = None
        for k, (dz, dy, dx) in enumerate(M.offsets):
            w = M.class_tables[k].reshape(-1)[cls]
            term = w * up[1 + dz:1 + dz + mz, 1 + dy:1 + dy + lm,
                          1 + dx:1 + dx + lm]
            acc = term if acc is None else acc + term
        mr = torch.where(z <= lm - 1, acc, 0.0)
        return torch.sum(r * mr, dtype=torch.float64)

    def check_norm(self, v, f):
        """sqrt(r^T M r), r = f - A v on the finest level, on the host as a
        numpy scalar of v's dtype (the sum's one host sync); the same value
        on every rank."""
        q = self.comm.sum_scalar(self.mass_partial(self.residual(self.L, v,
                                                                 f)))
        return NP_TYPES[v.dtype](math.sqrt(max(q, 0.0)))

    def dot(self, a, b):
        """a . b over the ranks, in a's dtype."""
        return torch.tensor(self.comm.sum_scalar(torch.sum(
            a * b, dtype=torch.float64)), dtype=a.dtype, device=a.device)

    # -- the loops -----------------------------------------------------
    def tolerance_loop(self, v, f, k0=0, hist0=None):
        """solver.fmg.tolerance_solve on the slabs, from cycle k0 with the
        history hist0."""
        spec = self.spec
        dtype = v.dtype
        np_dtype = NP_TYPES[dtype]
        max_c = spec.max_cycles
        res_h = torch.full((max_c,), float("nan"), dtype=dtype,
                           device=v.device)
        if hist0 is not None:
            n = min(int(hist0.shape[0]), max_c)
            res_h[:n] = torch.as_tensor(hist0, dtype=dtype)[:n].to(v.device)
        rn_ref = self.check_norm(torch.zeros_like(v), f)
        tol = np_dtype(spec.tol)
        rtol_thr = np_dtype(spec.rtol) * rn_ref
        growth = np_dtype(1e8)
        k = int(k0)
        rn0 = np_dtype(res_h[0].item()) if k > 0 else None
        converged = diverged = False
        while not converged and not diverged and k < max_c:
            v = self.vcycle(self.L, v, f)
            rn = self.check_norm(v, f)
            res_h[k] = float(rn)
            if rn0 is None:
                rn0 = rn
            converged = bool(rn <= tol)
            if spec.rtol > 0.0:
                converged = converged or bool(rn <= rtol_thr)
            diverged = bool(not np.isfinite(rn) or rn > growth * rn0)
            k += 1
        return SolveResult(u=v, res_hist=res_h, err_hist=torch.full_like(
            res_h, float("nan")), num_cycles=k, converged=converged,
            diverged=diverged)

    def mgcg(self):
        """solver.krylov.mgcg_solve (FMG start) on the slabs."""
        spec = self.spec
        L = self.L
        f = self.h.finest.b
        np_dtype = NP_TYPES[f.dtype]
        x = self.fmg_ramp(mu0=1, finest_cycles=True)
        zero = torch.zeros_like(f)

        def precond(r):
            return self.vcycle(L, torch.zeros_like(r), r)

        r = self.residual(L, x, f)
        z = precond(r)
        p = z
        rz = self.dot(r, z)
        hist = torch.full((spec.max_cycles,), float("nan"), dtype=f.dtype,
                          device=f.device)
        tol = np_dtype(spec.tol)
        rtol_thr = None
        if spec.rtol > 0.0:
            rtol_thr = np_dtype(spec.rtol) * self.check_norm(zero, f)
        k, converged, diverged = 0, False, False
        while not converged and not diverged and k < spec.max_cycles:
            Ap = self.residual(L, p, zero).neg_()
            alpha = rz / self.dot(p, Ap)
            x = x + alpha * p
            r_new = r - alpha * Ap
            z = precond(r_new)
            beta = self.dot(z, r_new - r) / rz
            p = z + beta * p
            rz = self.dot(r_new, z)
            r = r_new
            rn = self.check_norm(x, f)
            hist[k] = float(rn)
            converged = bool(rn <= tol) or (rtol_thr is not None
                                            and bool(rn <= rtol_thr))
            diverged = not bool(np.isfinite(rn))
            k += 1
        return CGResult(u=x, res_hist=hist, num_iters=k, converged=converged,
                        diverged=diverged)


# ----------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------

def _setup(config: SolverConfig, group, device, hierarchy):
    check_halo_config(config)
    comm = SlabComm(group)
    hier = (build_halo_hierarchy(config, comm, device) if hierarchy is None
            else hierarchy)
    return hier, _HaloOps(hier, config.cycle, comm)


def build_halo_solver3d(config: SolverConfig, group=None, device="cuda",
                        hierarchy: Optional[HaloHierarchy] = None):
    """(hierarchy, solve_fn): the distributed FMG start and tolerance loop.
    solve_fn(hier) returns a solver.fmg.SolveResult whose u is this rank's
    finest slab (gather_solution makes the whole grid) and whose res_hist
    is the same on every rank; err_hist stays NaN.  Every builder builds
    this rank's levels on `device` unless it is given `hierarchy` (one
    built for the same problem and ranks; its smoother data, the Jacobi
    weight and the Chebyshev degree, come from its own config)."""
    hier, ops = _setup(config, group, device, hierarchy)

    def solve_fn(h: HaloHierarchy):
        ops.h = h
        v = ops.fmg_ramp(config.cycle.mu0, finest_cycles=False)
        return ops.tolerance_loop(v, h.finest.b)

    return hier, solve_fn


def build_halo_cycler3d(config: SolverConfig, cycles: int, group=None,
                        device="cuda",
                        hierarchy: Optional[HaloHierarchy] = None):
    """(hierarchy, cycle_fn): cycle_fn(hier, v0) runs `cycles` finest
    V-cycles from the rank's slab v0, no norms and no FMG (the bench
    entry)."""
    hier, ops = _setup(config, group, device, hierarchy)

    def cycle_fn(h: HaloHierarchy, v0):
        ops.h = h
        v = v0
        for _ in range(cycles):
            v = ops.vcycle(ops.L, v, h.finest.b)
        return v

    return hier, cycle_fn


def build_halo_mgcg3d(config: SolverConfig, group=None, device="cuda",
                      hierarchy: Optional[HaloHierarchy] = None):
    """(hierarchy, mgcg_fn): flexible MG-CG from an FMG start (mu0 = 1 on
    every level), the distributed V-cycle as preconditioner; mgcg_fn(hier)
    returns a solver.krylov.CGResult with this rank's slab as u."""
    hier, ops = _setup(config, group, device, hierarchy)

    def mgcg_fn(h: HaloHierarchy):
        ops.h = h
        return ops.mgcg()

    return hier, mgcg_fn


def build_halo_resume3d(config: SolverConfig, group=None, device="cuda",
                        hierarchy: Optional[HaloHierarchy] = None):
    """(hierarchy, resume_fn): resume_fn(hier, v0, k0, hist0) continues the
    tolerance loop from this rank's slab v0 at cycle k0 with the history
    hist0 (NaN-padded to max_cycles); V-cycles keep no state between
    cycles, so the result is bitwise the uninterrupted solve's."""
    hier, ops = _setup(config, group, device, hierarchy)

    def resume_fn(h: HaloHierarchy, v0, k0, hist0):
        ops.h = h
        b = h.finest.b
        v0 = torch.as_tensor(v0, dtype=b.dtype).to(b.device)
        return ops.tolerance_loop(v0, b, int(k0), hist0)

    return hier, resume_fn


def gather_solution(hier: HaloHierarchy, u: torch.Tensor,
                    group=None) -> torch.Tensor:
    """The finest level's whole lm^3 grid from every rank's slab, on every
    rank."""
    comm = SlabComm(group)
    lm = hier.plan.lms[-1]
    return comm.gather_z(u)[:lm].contiguous()


def halo_extend_z(u: torch.Tensor, depth: int, group=None) -> torch.Tensor:
    """(mz, lm, lm) block -> (mz + 2 depth, lm, lm) with the neighbours'
    z-slabs (zeros at the domain edges)."""
    lo, hi = SlabComm(group).halos(u, depth)
    return torch.cat([lo, u, hi])


def _distributed_smoother(nsweeps: int, group, sweep: Callable, depth: int):
    comm = SlabComm(group)

    def fn(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        z_base = comm.rank * v.shape[0]
        flo, fhi = comm.halos(f, depth)
        for _ in range(nsweeps):
            vlo, vhi = comm.halos(v, depth)
            v = sweep(v, f, vlo, vhi, flo, fhi, z_base)
        return v

    return fn


def make_distributed_rb_smoother(lm: int, wc: float, woff: float,
                                 nsweeps: int, group=None):
    """fn(v, f) -> v after `nsweeps` red-black GS sweeps (K25) on the
    rank's z-slab of the lm^3 const-7 system (rank r holds the slabs from
    z = r mz; mz even)."""
    def sweep(v, f, vlo, vhi, flo, fhi, zb):
        return dispatch.rb_sweep_dist(v, f, vlo, vhi, flo, fhi, lm, wc, woff,
                                      zb)
    return _distributed_smoother(nsweeps, group, sweep, 2)


def make_distributed_jacobi_smoother(lm: int, wc: float, woff: float,
                                     omega: float, nsweeps: int, group=None):
    """As make_distributed_rb_smoother, for weighted Jacobi (K26)."""
    def sweep(v, f, vlo, vhi, flo, fhi, zb):
        return dispatch.jacobi_sweep_dist(v, f, vlo, vhi, flo, fhi, lm, wc,
                                          woff, omega, zb)
    return _distributed_smoother(nsweeps, group, sweep, 1)

