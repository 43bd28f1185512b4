"""The V-cycle of the port, run eagerly level by level.

Mirrors `multigrid_dolfinx_tpu.solver.vcycle` on its per-level path.  In
3D every level, the coarse ones included, runs ν1 red-black sweeps (K1),
the fused residual + P^T restriction (K2), the recursion with a zero
initial guess down to the factorised coarse solve, the fused
prolongation + correction (K3) and ν2 sweeps; the JAX package's fused
coarse tail (levels <= 65^3 in two kernels) is ROADMAP.md queue 2,
item 1.  In 2D a level runs ν1 sweeps (K5 Jacobi or K6 red-black), the
residual (K7), its restriction (K8 for 'pt', plain injection otherwise),
the recursion, v + P(vc) through K9 (the JAX package has no fused 2D
correction) and ν2 sweeps.
"""
from __future__ import annotations

import torch

from ..config import CycleSpec
from ..ops import dispatch, transfer
from ..ops.smoothers import smooth
from .hierarchy import Hierarchy


def check_slice(spec: CycleSpec, ndim: int) -> None:
    """Raise NotImplementedError for cycle options outside the port's
    slice, naming the ROADMAP.md item that brings them."""
    if spec.smoother == "chebyshev":
        raise NotImplementedError(
            "smoother 'chebyshev' is ROADMAP.md queue 1, item 13")
    if spec.cycle != "V":
        raise NotImplementedError(
            f"{spec.cycle}-cycles are ROADMAP.md queue 1, item 8")
    if spec.restriction == "full_weighting" or spec.prolongation != "bilinear":
        raise NotImplementedError(
            "'full_weighting' restriction and 'p1' prolongation are "
            "ROADMAP.md queue 1, item 5")
    if ndim == 3 and spec.smoother == "jacobi":
        raise NotImplementedError(
            "3D weighted Jacobi needs stencil3d.jacobi_sweep, ROADMAP.md "
            "queue 2, item 4")
    if ndim == 3 and spec.restriction == "injection":
        raise NotImplementedError(
            "3D injection needs the two-step residual stencil3d.residual, "
            "ROADMAP.md queue 2, item 2")


def compute_residual(level, v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """r = f - A v: kernel K7 in 2D, plain torch in 3D (the 3D cycle
    never stores r)."""
    if v.ndim == 2:
        dispatch.require_const5(level.A)
        return dispatch.residual_2d(v, f, level.n + 1)
    return f - level.A.apply(v)


def restrict_level(r: torch.Tensor, lv, lv_c, kind: str) -> torch.Tensor:
    """Restrict a 2D fine residual.  'pt' is the pure correction
    equation: the error vanishes at Dirichlet nodes, so K8 masks the fine
    boundary residual out and zeroes the coarse boundary.  'injection'
    carries the boundary residual through, as the reference does."""
    if kind == "pt":
        return dispatch.restrict_pt_2d(r, lv.n + 1, lv_c.n + 1)
    return transfer.restrict(r, kind)


def prolong_level(vc: torch.Tensor, fine_level,
                  v: torch.Tensor = None) -> torch.Tensor:
    """P(vc), or the correction v + P(vc) when v is given: K3 (fused with
    the add) in 3D, K9 and then the add in 2D."""
    lmf = fine_level.n + 1
    if vc.ndim == 2:
        e = dispatch.prolong_linear_2d(vc, lmf)
        return e if v is None else v + e
    return dispatch.prolong_linear(vc, lmf, v)


def _coarse_rhs(lv, lv_c, v, f, spec: CycleSpec) -> torch.Tensor:
    """The coarse right-hand side from the smoothed v: P^T (f - A v) in
    one pass over v and f (K2) in 3D, residual then restriction in 2D."""
    if v.ndim == 2:
        return restrict_level(compute_residual(lv, v, f), lv, lv_c,
                              spec.restriction)
    wc, woff = dispatch.const7_weights(lv.A)
    return dispatch.restrict_residual_pt(v, f, lv.n + 1, lv_c.n + 1, wc, woff)


def vcycle(hier: Hierarchy, spec: CycleSpec, lidx: int, v: torch.Tensor,
           f: torch.Tensor, collect_debug: bool = False):
    """One V-cycle at level index `lidx` (0 = coarsest) from initial guess
    v with right-hand side f.  With collect_debug=True also returns
    (restricted residual, coarse error, interpolated correction), with the
    correction prolonged and added in two steps."""
    check_slice(spec, v.ndim)
    if lidx == 0:
        u = hier.coarse.solve(f)
        return (u, None) if collect_debug else u
    lv = hier.levels[lidx]
    lv_c = hier.levels[lidx - 1]
    v = smooth(lv.sm, lv.A, v, f, spec.nu1, spec.smoother)
    fc = _coarse_rhs(lv, lv_c, v, f, spec)
    vc = vcycle(hier, spec, lidx - 1, torch.zeros_like(fc), fc)
    if collect_debug:
        e = prolong_level(vc, lv)
        v = v + e
    else:
        v = prolong_level(vc, lv, v)
    v = smooth(lv.sm, lv.A, v, f, spec.nu2, spec.smoother)
    if collect_debug:
        return v, (fc, vc, e)
    return v
