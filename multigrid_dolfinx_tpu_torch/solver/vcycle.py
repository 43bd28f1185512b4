"""The V-cycle of the port, run eagerly level by level.

Mirrors `multigrid_dolfinx_tpu.solver.vcycle` on its per-level path.  In
3D every level, the coarse ones included, runs ν1 sweeps (K1 red-black,
K11 Jacobi or K12 Chebyshev steps), the fused residual + P^T restriction
(K2; with injection the residual K10 and a strided copy), the recursion
with a zero initial guess down to the factorised coarse solve, the fused
prolongation + correction (K3) and ν2 sweeps.  As in the JAX package,
an f32 red-black V-cycle runs the levels at and below TAIL_MAX_LM as the
fused coarse tail: the down leg (K13), the coarse solve and the up leg
(K14), two launches in all.  A 3D stored-planes level (variable kappa,
Galerkin) runs ν1 sweeps (K17 multicolour GS or K16 Jacobi), the
residual (K15) and its P^T restriction (K18) in two steps, the
recursion, the correction through K3 and ν2 sweeps; a 3D P2 parity level
the same with K20 snap-Jacobi sweeps and the residual K19.  In 2D a
level runs ν1 sweeps (K5 Jacobi, K6 red-black or Chebyshev on K7; on
stored planes K23 Jacobi or K24 multicolour GS), the residual (K7; K22
on planes), its restriction (K8 for 'pt', plain injection otherwise),
the recursion, v + P(vc) through K9 (the JAX package has no fused 2D
correction) and ν2 sweeps.
"""
from __future__ import annotations

import torch

from ..config import CycleSpec
from ..ops import dispatch, transfer
from ..ops.smoothers import smooth
from .hierarchy import Hierarchy

#: Top level size of the fused coarse tail (the JAX package's
#: stencil3d_tail.tail_max_lm() default).
TAIL_MAX_LM = 65


def check_slice(spec: CycleSpec) -> None:
    """Raise NotImplementedError for cycle options outside the port's
    slice, naming the ROADMAP.md item that brings them."""
    if spec.cycle != "V":
        raise NotImplementedError(
            f"{spec.cycle}-cycles are ROADMAP.md queue 1, item 8")
    if spec.restriction == "full_weighting" or spec.prolongation != "bilinear":
        raise NotImplementedError(
            "'full_weighting' restriction and 'p1' prolongation are "
            "ROADMAP.md queue 1, item 5")


def compute_residual(level, v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """r = f - A v: kernel K7 in 2D, K10 in 3D (boundary rows f - v), K15
    on 3D stored planes, K22 on 2D ones, K19 on the P2 parity operator."""
    lm = level.n + 1
    if level.A.parity_tables is not None:
        return dispatch.p2_residual(v, f, level.A.parity_tables,
                                    level.A.offsets)
    if level.A.planes is not None:
        residual = (dispatch.planes2_residual if v.ndim == 2
                    else dispatch.planes3_residual)
        return residual(v, f, level.A.planes, level.A.offsets)
    if v.ndim == 2:
        dispatch.require_const5(level.A)
        return dispatch.residual_2d(v, f, lm)
    wc, woff = dispatch.const7_weights(level.A)
    return dispatch.residual(v, f, lm, wc, woff)


def restrict_level(r: torch.Tensor, lv, lv_c, kind: str) -> torch.Tensor:
    """Restrict a fine residual: 'pt' through K8 in 2D and K18 in 3D,
    'injection' (2D and 3D) as a strided copy.  'pt' is the pure
    correction equation: the error vanishes at Dirichlet nodes, so the
    kernels mask the fine boundary residual out and zero the coarse
    boundary.  'injection' carries the boundary residual through, as the
    reference does."""
    if kind == "pt":
        if r.ndim == 3:
            return dispatch.restrict_pt(r, lv.n + 1, lv_c.n + 1)
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
    one pass over v and f (K2) on const-7 levels, residual then
    restriction in 2D, on planes levels (K15, K18), on P2 parity levels
    (K19, K18) and for injection."""
    if (v.ndim == 2 or spec.restriction != "pt"
            or dispatch.const7_weights(lv.A) is None):
        return restrict_level(compute_residual(lv, v, f), lv, lv_c,
                              spec.restriction)
    wc, woff = dispatch.const7_weights(lv.A)
    return dispatch.restrict_residual_pt(v, f, lv.n + 1, lv_c.n + 1, wc, woff)


def fused_tail_levels(hier: Hierarchy, spec: CycleSpec, j: int):
    """(lms, weights) of the sub-hierarchy 0..j, coarsest first, when the
    fused coarse tail runs it: V-cycles with red-black smoothing, 3D f32
    const-7 levels, the top at most TAIL_MAX_LM (the JAX package's
    _fused_tail_levels; its TPU tiling and VMEM checks do not apply to
    unpadded storage on the card).  Else None."""
    if spec.cycle != "V" or j < 1 or spec.smoother != "rbgs":
        return None
    top = hier.levels[j]
    if top.b.ndim != 3 or top.b.dtype != torch.float32:
        return None
    if top.n + 1 > TAIL_MAX_LM:
        return None
    weights = []
    for lv in hier.levels[:j + 1]:
        w = dispatch.const7_weights(lv.A)
        if w is None:
            return None
        weights.append(w)
    return tuple(lv.n + 1 for lv in hier.levels[:j + 1]), tuple(weights)


def tail_or_recurse(hier: Hierarchy, spec: CycleSpec, j: int,
                    f: torch.Tensor) -> torch.Tensor:
    """The recursion into level j from a zero guess: the fused tail (down
    leg, coarse solve, up leg) when it applies, else the per-level
    V-cycle."""
    levels = fused_tail_levels(hier, spec, j)
    if levels is None:
        return vcycle(hier, spec, j, torch.zeros_like(f), f)
    lms, weights = levels
    vs, fs = dispatch.tail_down(f, lms, weights, spec.nu1)
    v0 = hier.coarse.solve(fs[-1])
    return dispatch.tail_up(v0, f, vs, fs[:-1], lms, weights, spec.nu2)


def vcycle(hier: Hierarchy, spec: CycleSpec, lidx: int, v: torch.Tensor,
           f: torch.Tensor, collect_debug: bool = False):
    """One V-cycle at level index `lidx` (0 = coarsest) from initial guess
    v with right-hand side f.  With collect_debug=True also returns
    (restricted residual, coarse error, interpolated correction), with the
    correction prolonged and added in two steps."""
    check_slice(spec)
    if lidx == 0:
        u = hier.coarse.solve(f)
        return (u, None) if collect_debug else u
    lv = hier.levels[lidx]
    lv_c = hier.levels[lidx - 1]
    v = smooth(lv.sm, lv.A, v, f, spec.nu1, spec.smoother)
    fc = _coarse_rhs(lv, lv_c, v, f, spec)
    vc = tail_or_recurse(hier, spec, lidx - 1, fc)
    if collect_debug:
        e = prolong_level(vc, lv)
        v = v + e
    else:
        v = prolong_level(vc, lv, v)
    v = smooth(lv.sm, lv.A, v, f, spec.nu2, spec.smoother)
    if collect_debug:
        return v, (fc, vc, e)
    return v
