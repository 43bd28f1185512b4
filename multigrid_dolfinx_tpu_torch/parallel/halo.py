"""The distributed 2D row-strip solve over torch.distributed.

Mirrors `multigrid_dolfinx_tpu.parallel.halo` for constant-coefficient P1
in 2D on its row-decomposed ('gx', 1) mesh, the layout the JAX package's
kernels (ops/pallas/stencil2d_dist.py) run.  Every rank holds a strip of
rows of every level at or above `shard_from` (the plan of
`pick_shard_pad_plan`: rows padded to a multiple of 4 P that doubles up
the levels); the levels below are replicated, and every rank runs them
redundantly with the single-device 2D code (solver.vcycle, K5-K9).

On a sharded level a V-cycle runs ν1 sweeps (K30 red-black with 2-deep
halos of v and f, K31 Jacobi with 1-deep halos of v and df = dinv f
hoisted, or Chebyshev in the p-form of `ops.smoothers.chebyshev_smooth`
on the residual K32), the residual K32 and its restriction (P^T through
K33 with the -row neighbour's last row; injection as a strided copy of
the strip's even rows, globally even since row_base is), the recursion,
the prolongation + correction K34 and ν2 sweeps.  Going down into the
replicated levels each rank restricts its strip first and then
all-gathers the coarse grid; going up, each rank prolongs the replicated
grid (K9), cuts its strip and adds it.  The check after each cycle is
the FEM-L2 class-table mass quadratic form of the residual with a 1-deep
row halo, one f64 partial per rank, summed in rank order on every rank
(`SlabComm.sum_scalar`).  Each point of a sharded kernel keeps the
single-device association, so the gathered iterate is bitwise the
single-device one.

Entry points (each called on every rank after `init_process_group`;
`device` defaults to the CUDA card): `build_halo_solver` (FMG + the
tolerance loop), `build_halo_cycler` (k chained V-cycles) and
`pick_shard_pad_plan`; `parallel.halo3d.gather_solution` gathers a
strip-distributed solution.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import SolverConfig
from ..ops import dispatch
from ..ops.cuda.stencil2d_dist import row_coords, strip_interior
from ..ops.operators import axis_class
from ..ops.smoothers import NP_TYPES, cheby_phase, cheby_window
from ..solver.hierarchy import check_problem, resolve_device
from ..solver.vcycle import tail_or_recurse
from ..solver.vcycle import vcycle as vcycle_replicated
from .comm import SlabComm
from .halo3d import (HaloHierarchy, _HaloOps, check_halo_cycle, cut_slab,
                     pick_z_shard_plan, slab_hierarchy)


def pick_shard_pad_plan(config: SolverConfig, ngx: int):
    """(plan, shard_from) for row strips over `ngx` ranks: levels from
    shard_from up get (rows, lm), rows padded to the quantum 4 ngx and
    doubling up the levels (so every strip holds a multiple of 4 rows,
    every row_base is even and transfers stay strip-local); the levels
    below get (lm, lm) and stay replicated (halo3d.pick_z_shard_plan in
    2D).

    Named after the JAX package's pick_shard_pad_plan, which differs on
    purpose: it pads every level in both axes to m0 2^i with m0 the
    coarsest size rounded up to the mesh, shards every level and gathers
    only for the coarse solve.  Here columns are stored unpadded, and the
    coarse levels, where a strip would hold a few rows, are replicated."""
    return pick_z_shard_plan(config, ngx, align=True)


def check_row_config(config: SolverConfig,
                     mesh_shape: Optional[Tuple[int, int]] = None) -> None:
    """Raise for problems, layouts and cycle options outside the
    distributed 2D slice, naming what brings each."""
    p = config.problem
    if p.ndim != 2:
        raise NotImplementedError(
            "the distributed 3D z-slab solve is parallel.halo3d."
            "build_halo_solver3d")
    if p.degree != 1:
        raise NotImplementedError(
            "distributed 2D P2 follows 2D P2, ROADMAP.md queue 1, items 21 "
            "and 18")
    if p.kappa is not None:
        raise NotImplementedError(
            "distributed 2D variable kappa is ROADMAP.md queue 1, item 18")
    if mesh_shape is not None and tuple(mesh_shape)[1:] != (1,):
        raise NotImplementedError(
            f"the ({mesh_shape[0]}, {mesh_shape[1]}) block layout (halos "
            "in both axes, the two-phase corner relay) is ROADMAP.md queue "
            "1, item 18; the port runs row strips, (P, 1)")
    if config.cycle.coarse_solver not in ("cholesky", "inverse"):
        raise NotImplementedError(
            "the distributed 2D solve takes the 'cholesky' or 'inverse' "
            "coarse solve, as the JAX package's halo path does")
    check_problem(config)
    check_halo_cycle(config.cycle)


def build_row_hierarchy(config: SolverConfig, comm: SlabComm,
                        device="cuda") -> HaloHierarchy:
    """This rank's levels on `device`: the lean 2D build, each sharded
    level's b and g built whole and cut to the rank's row strip at once,
    so the strip equals the single-device build's rows bitwise."""
    check_row_config(config)
    return slab_hierarchy(config, comm, device)


class _RowOps(_HaloOps):
    """The per-rank operations of the distributed 2D cycle (the JAX
    package's local_solve on a ('gx', 1) mesh)."""

    def _dinv(self, li, v):
        """1 / diag of the const-5 operator on the rank's strip (A.dinv's
        arithmetic; 1 on boundary and padding rows)."""
        A = self.h.levels[li].A
        interior = strip_interior(v.shape[0], self.lm(li),
                                  self.h.z_base(li), v.device)
        one = torch.ones((), dtype=v.dtype, device=v.device)
        return torch.where(interior, one / A.const_weights[A.center_index()],
                           one)

    def residual(self, li, v, f):
        """r = f - A v on the rank's strip (K32)."""
        vlo, vhi = self.comm.halos(v, 1)
        return dispatch.residual_dist_2d(v, f, vlo, vhi, self.lm(li),
                                         self.h.z_base(li))

    def smooth(self, li, v, f, n, fh):
        """n sweeps of the configured smoother.  fh is a one-slot cell for
        f's 2-deep halos, exchanged with v's in the first red-black sweep
        of a level and kept for the rest of the V-cycle there."""
        if n <= 0:
            return v
        lv = self.h.levels[li]
        dispatch.require_const5(lv.A)
        lm, rb = self.lm(li), self.h.z_base(li)
        kind = self.spec.smoother
        if kind == "chebyshev":
            return self._chebyshev(li, lv, v, f, n)
        if kind == "jacobi":
            df = self._dinv(li, v) * f      # hoisted once per call
            for _ in range(n):
                vlo, vhi = self.comm.halos(v, 1)
                v = dispatch.jacobi_sweep_dist_2d(v, df, vlo, vhi, lm,
                                                  lv.sm.omega, rb)
            return v
        for _ in range(n):
            if fh[0] is None:
                vlo, vhi, flo, fhi = self.comm.halos2(v, f, 2)
                fh[0] = (flo, fhi)
            else:
                vlo, vhi = self.comm.halos(v, 2)
            v = dispatch.rb_sweep_dist_2d(v, f, vlo, vhi, *fh[0], lm, rb)
        return v

    def _chebyshev(self, li, lv, v, f, n):
        """ops.smoothers.chebyshev_smooth on the strip: p-form steps on
        z = dinv r, r from K32, the window from the level's lmax."""
        dinv = self._dinv(li, v)
        rounds, degree = cheby_phase(n, lv.sm.cheby_degree)
        theta, delta, sigma = cheby_window(lv.sm, v.dtype)
        one, two = type(theta)(1.0), type(theta)(2.0)
        for _ in range(rounds):
            p = (dinv * self.residual(li, v, f)) / float(theta)
            v = v + p
            rho_prev = one / sigma
            for _ in range(1, degree):
                z = dinv * self.residual(li, v, f)
                rho = one / (two * sigma - rho_prev)
                p = float(rho * rho_prev) * p + float(two * rho / delta) * z
                v = v + p
                rho_prev = rho
        return v

    def coarse_rhs(self, li, v, f):
        """The level li-1 right-hand side from the residual K32: K33 (P^T)
        or the even rows and columns (injection) of the strip; into a
        replicated level, all-gathered and cropped."""
        lmf, lmc = self.lm(li), self.lm(li - 1)
        r = self.residual(li, v, f)
        if self.spec.restriction == "pt":
            rlo = self.comm.shift_slabs(r[-1:], forward=True)
            fc = dispatch.restrict_pt_dist_2d(r, rlo, lmf, lmc,
                                              self.h.z_base(li))
        else:
            fc = r[::2, ::2].contiguous()
        if li - 1 >= self.s:
            return fc
        return self.comm.gather_z(fc)[:lmc].contiguous()

    def prolong(self, li, vc, v=None):
        """P(vc) on level li's strip, or v + P(vc): K34 between sharded
        levels; from the replicated level li-1, K9 on the whole grid, then
        the rank's strip."""
        if li - 1 >= self.s:
            chi = self.comm.shift_slabs(vc[:1], forward=False)
            return dispatch.prolong_add_dist_2d(vc, chi, self.lm(li),
                                                self.h.z_base(li), v)
        e = cut_slab(dispatch.prolong_linear_2d(vc, self.lm(li)),
                     self.h.plan.mz(li), self.h.rank)
        return e if v is None else v + e

    def vcycle(self, li, v, f):
        """One V-cycle at level li (sharded or replicated)."""
        if li < self.s:
            return vcycle_replicated(self.h.local, self.spec, li, v, f)
        spec = self.spec
        fh = [None]
        v = self.smooth(li, v, f, spec.nu1, fh)
        fc = self.coarse_rhs(li, v, f)
        if li - 1 >= self.s:
            vc = self.vcycle(li - 1, torch.zeros_like(fc), fc)
        else:
            vc = tail_or_recurse(self.h.local, spec, li - 1, fc)
        v = self.prolong(li, vc, v)
        return self.smooth(li, v, f, spec.nu2, fh)

    def mass_partial(self, r):
        """This rank's share of r^T M r (the class-table mass of the
        single-device check, 1-deep row halo), summed in f64."""
        M = self.h.local.M_fine
        lm = self.lm(self.L)
        m = r.shape[0]
        lo, hi = self.comm.halos(r, 1)
        up = F.pad(torch.cat([lo, r, hi]), (1, 1))
        i, _ = row_coords(m, lm, self.h.z_base(self.L), r.device)
        ci = torch.where(i == 0, 0, torch.where(i == lm - 1, 2, 1))
        cls = ci * 3 + axis_class(lm, lm, r.device).view(1, -1)
        acc = None
        for k, (di, dj) in enumerate(M.offsets):
            w = M.class_tables[k].reshape(-1)[cls]
            term = w * up[1 + di:1 + di + m, 1 + dj:1 + dj + lm]
            acc = term if acc is None else acc + term
        mr = torch.where(i <= lm - 1, acc, 0.0)
        return torch.sum(r * mr, dtype=torch.float64)

    def check_norm(self, v, f):
        """sqrt(r^T M r), r = f - A v on the finest level, as a numpy
        scalar of v's dtype, the quadratic form rounded to that dtype
        before the root as the single-device 2D check rounds it; the same
        value on every rank."""
        t = NP_TYPES[v.dtype]
        q = self.comm.sum_scalar(self.mass_partial(self.residual(self.L, v,
                                                                 f)))
        return t(math.sqrt(max(float(t(q)), 0.0)))


def _setup(config: SolverConfig, group, device, hierarchy, mesh_shape):
    check_row_config(config, mesh_shape)
    resolve_device(device)
    comm = SlabComm(group)
    if mesh_shape is not None and mesh_shape[0] != comm.size:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} does not match the "
                         f"group's {comm.size} ranks")
    hier = (build_row_hierarchy(config, comm, device) if hierarchy is None
            else hierarchy)
    return hier, _RowOps(hier, config.cycle, comm)


def build_halo_solver(config: SolverConfig, group=None, device="cuda",
                      hierarchy: Optional[HaloHierarchy] = None,
                      mesh_shape: Optional[Tuple[int, int]] = None):
    """(hierarchy, solve_fn): the distributed FMG start and tolerance loop
    on row strips.  solve_fn(hier) returns a solver.fmg.SolveResult whose
    u is this rank's finest strip (gather_solution makes the whole grid)
    and whose res_hist is the same on every rank; err_hist stays NaN.
    The levels are built on `device` (the CUDA card by default; without
    one this raises) unless `hierarchy` is given (one built for the same
    problem and ranks).  mesh_shape, where given, is the JAX package's
    (px, py) mesh: (P, 1) is the layout this runs; py > 1 raises."""
    hier, ops = _setup(config, group, device, hierarchy, mesh_shape)

    def solve_fn(h: HaloHierarchy):
        ops.h = h
        v = ops.fmg_ramp(config.cycle.mu0, finest_cycles=False)
        return ops.tolerance_loop(v, h.finest.b)

    return hier, solve_fn


def build_halo_cycler(config: SolverConfig, cycles: int, group=None,
                      device="cuda", hierarchy: Optional[HaloHierarchy] = None,
                      mesh_shape: Optional[Tuple[int, int]] = None):
    """(hierarchy, cycle_fn): cycle_fn(hier, v0) runs `cycles` finest
    V-cycles from the rank's strip v0, no norms and no FMG (the bench
    entry, the JAX package's build_halo_cycler)."""
    hier, ops = _setup(config, group, device, hierarchy, mesh_shape)

    def cycle_fn(h: HaloHierarchy, v0):
        ops.h = h
        v = v0
        for _ in range(cycles):
            v = ops.vcycle(ops.L, v, h.finest.b)
        return v

    return hier, cycle_fn
