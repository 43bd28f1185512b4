"""Full Multigrid and the tolerance-driven solve loop of the port.

Mirrors `multigrid_dolfinx_tpu.solver.fmg`.  PyTorch runs eagerly, so
`tolerance_solve` is a host loop with one scalar read per cycle (the
residual norm); the histories are preallocated NaN-filled tensors on the
device, as the JAX package's fixed-size buffers.  The per-cycle check
r = f - A v, sqrt(r^T M r) on a 3D const-7 level is one kernel pass over
v and f, routed by the mass operator as the JAX package routes it
(fmg._fused_residual_norm): K4 where `uniform_p1_mass` certifies the
uniform P1 mass, else K38 on the class tables, and where K38 does not
admit them the residual and the plain class-table norm.  In 2D it is the
residual kernel K7 and the plain class-table mass norm, as the JAX
package computes it (it has no fused 2D norm kernel), and on a
stored-planes finest level the residual kernel (K15 in 3D, K22 in 2D)
and the plain class-table norm, as the JAX package falls back to; on a
P2 parity finest level the residual K19 and the raw mass quadratic form K21.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CycleSpec
from ..ops import dispatch
from ..ops.operators import mass_norm
from .hierarchy import Hierarchy
from .vcycle import compute_residual, prolong_level, vcycle


class SolveResult(NamedTuple):
    """Solution and convergence telemetry.  res_hist / err_hist are
    (max_cycles,) tensors on the hierarchy's device, NaN beyond
    num_cycles; num_cycles, converged and diverged are host values."""

    u: torch.Tensor
    res_hist: torch.Tensor
    err_hist: torch.Tensor
    num_cycles: int
    converged: bool
    diverged: bool


def residual_norm(hier: Hierarchy, r: torch.Tensor) -> torch.Tensor:
    """FEM-L2 (mass-weighted) residual norm, plain class-table form."""
    return mass_norm(hier.M_fine, r)


def error_norm(hier: Hierarchy, u: torch.Tensor) -> torch.Tensor:
    """FEM-L2 error against the manufactured solution, per quadrature
    point: sum_s vol_s sum_q w_q (u_h(x_q) - u*(x_q))^2, with u*(x_q)
    evaluated on the fly from cell indices."""
    eq = hier.err_quad
    nc, st = eq.ncells, eq.stride
    iotas = []
    for axis in range(u.ndim):
        view = [1] * u.ndim
        view[axis] = nc
        iotas.append(torch.arange(nc, device=u.device).to(u.dtype)
                     .view(view) * eq.h)
    acc = None
    for s, voffs in enumerate(eq.voffs):
        for q, vw in enumerate(eq.vw[s]):
            interp = None
            for a, voff in enumerate(voffs):
                slab = tuple(slice(o, o + st * (nc - 1) + 1, st)
                             for o in voff)
                term = eq.lambdas[s][q][a] * u[slab]
                interp = term if interp is None else interp + term
            xq = [io + xo for io, xo in zip(iotas, eq.xq_local[s][q])]
            e = interp - eq.exact_fn(*xq)
            contrib = vw * torch.sum(e * e)
            acc = contrib if acc is None else acc + contrib
    return torch.sqrt(torch.clamp(acc, min=0.0))


def check_norm(hier: Hierarchy, v: torch.Tensor,
               f: torch.Tensor) -> torch.Tensor:
    """The per-cycle check sqrt(r^T M r), r = f - A v, in v's dtype.  On
    a 3D const-7 level the mass operator's structure picks the route, as
    the JAX package's does: kernel K4 for a mass certified the uniform P1
    mass, kernel K38 on the class tables of any other that K38 admits
    (dispatch.mass_quad_admits), else the residual and the plain
    class-table norm.  On a P2 parity level K19 and K21 (exact at face
    rows too, so it also gives ||b||_M of the zero iterate); otherwise
    the residual kernel (K7 in 2D, K15 / K22 on 3D / 2D planes) and the
    class-table norm."""
    lv = hier.finest
    if lv.A.parity_tables is not None:
        M = hier.M_fine
        q = dispatch.p2_residual_mass_quad(v, f, lv.A.parity_tables,
                                           lv.A.offsets, M.parity_tables,
                                           M.offsets)
        return torch.sqrt(torch.clamp(q, min=0.0)).to(v.dtype)
    if v.ndim == 2 or lv.A.planes is not None:
        return residual_norm(hier, compute_residual(lv, v, f))
    wc, woff = dispatch.const7_weights(lv.A)
    M = hier.M_fine
    if M.uniform_p1_mass in ("right", "left"):
        q = dispatch.residual_tet_quad(v, f, lv.n + 1, wc, woff,
                                       M.uniform_p1_mass)
    elif dispatch.mass_quad_admits(M):
        q = dispatch.residual_mass_quad(v, f, M.class_tables, M.offsets,
                                        lv.n + 1, wc, woff)
    else:
        return residual_norm(hier, compute_residual(lv, v, f))
    return torch.sqrt(torch.clamp(q, min=0.0)).to(v.dtype)


def tolerance_solve(hier: Hierarchy, spec: CycleSpec, v0: torch.Tensor,
                    f: torch.Tensor) -> SolveResult:
    """V-cycles until the residual drops below tol (or rtol times the
    zero iterate's residual), with NaN, growth and max-cycle guards."""
    L = hier.num_levels - 1
    dtype = v0.dtype
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    max_c = spec.max_cycles
    res_h = torch.full((max_c,), float("nan"), dtype=dtype, device=v0.device)
    err_h = torch.full((max_c,), float("nan"), dtype=dtype, device=v0.device)
    # rtol is measured against the zero iterate's residual, not the
    # post-FMG one (FMG already lands near the discretisation floor).
    # Thresholds are formed in the solve's dtype, as the JAX loop does.
    rn_ref = np_dtype(check_norm(hier, torch.zeros_like(v0), f).item())
    tol = np_dtype(spec.tol)
    rtol_thr = np_dtype(spec.rtol) * rn_ref
    growth = np_dtype(1e8)
    v = v0
    k, converged, diverged, rn0 = 0, False, False, None
    while not converged and not diverged and k < max_c:
        v = vcycle(hier, spec, L, v, f)
        rn_t = check_norm(hier, v, f)
        res_h[k] = rn_t
        if spec.track_error:
            err_h[k] = error_norm(hier, v)
        rn = np_dtype(rn_t.item())
        if k == 0:
            rn0 = rn
        converged = bool(rn <= tol)
        if spec.rtol > 0.0:
            converged = converged or bool(rn <= rtol_thr)
        diverged = bool(not np.isfinite(rn) or rn > growth * rn0)
        k += 1
    return SolveResult(u=v, res_hist=res_h, err_hist=err_h, num_cycles=k,
                       converged=converged, diverged=diverged)


def fmg_ramp(hier: Hierarchy, spec: CycleSpec, mode: str = "fixed",
             collect_debug: bool = False):
    """Nested iteration from the coarsest level up: the coarse solve, then
    on each finer level the iterate prolonged by spec.prolongation and mu0
    cycles of spec's shape and fusions.
    mode='tol' leaves the finest level's prolonged iterate uncycled (the
    tolerance loop takes it from there).  Returns (v, debug): debug is the
    finest cycle's internals under collect_debug in fixed mode, else
    None."""
    nlev = hier.num_levels
    v = hier.coarse.solve(hier.levels[0].b)
    debug = None
    for li in range(1, nlev):
        v = prolong_level(v, hier.levels[li], kind=spec.prolongation)
        is_finest = li == nlev - 1
        if is_finest and mode == "tol":
            break
        f = hier.levels[li].b
        for c in range(spec.mu0):
            if collect_debug and is_finest and c == spec.mu0 - 1:
                v, debug = vcycle(hier, spec, li, v, f, collect_debug=True)
            else:
                v = vcycle(hier, spec, li, v, f)
    return v, debug


def fmg_solve(hier: Hierarchy, spec: CycleSpec, mode: str = "tol",
              collect_debug: bool = False):
    """Full Multigrid from the coarsest level up.  mode='tol' runs mu0
    V-cycles on each intermediate level and the tolerance loop on the
    finest; mode='fixed' runs mu0 cycles on every level including the
    finest (collect_debug then also returns the finest cycle's internals)."""
    if mode not in ("tol", "fixed"):
        raise ValueError(f"mode must be 'tol' or 'fixed', got {mode!r}")
    v, debug = fmg_ramp(hier, spec, mode, collect_debug)
    if hier.num_levels == 1:
        nan = torch.full((spec.max_cycles,), float("nan"), dtype=v.dtype,
                         device=v.device)
        res = SolveResult(u=v, res_hist=nan, err_hist=nan.clone(),
                          num_cycles=0, converged=True, diverged=False)
        return (res, debug) if collect_debug else res
    if mode == "tol":
        result = tolerance_solve(hier, spec, v, hier.finest.b)
        return (result, debug) if collect_debug else result

    # fixed mode: final norms once, for telemetry
    f = hier.finest.b
    rn = residual_norm(hier, compute_residual(hier.finest, v, f))
    en = (error_norm(hier, v) if spec.track_error
          else torch.tensor(float("nan"), dtype=v.dtype, device=v.device))
    res_h = torch.full((spec.max_cycles,), float("nan"), dtype=v.dtype,
                       device=v.device)
    err_h = res_h.clone()
    res_h[0] = rn
    err_h[0] = en
    rn_host = float(rn)
    result = SolveResult(u=v, res_hist=res_h, err_hist=err_h,
                         num_cycles=spec.mu0, converged=rn_host <= spec.tol,
                         diverged=not np.isfinite(rn_host))
    return (result, debug) if collect_debug else result


def resume_solve(hier: Hierarchy, spec: CycleSpec, v0) -> SolveResult:
    """Continue V-cycling from a previous iterate until tolerance."""
    b = hier.finest.b
    v0 = torch.as_tensor(v0, dtype=b.dtype, device=b.device)
    return tolerance_solve(hier, spec, v0, b)


def solve(hier: Hierarchy, spec: CycleSpec, mode: str = "tol") -> SolveResult:
    """FMG solve over a prebuilt hierarchy."""
    return fmg_solve(hier, spec, mode=mode)
