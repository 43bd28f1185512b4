"""The multigrid cycle of the port (V, W or F), run eagerly level by level.

Mirrors `multigrid_dolfinx_tpu.solver.vcycle` on its per-level path.  In
3D every level, the coarse ones included, runs ν1 sweeps (K1 red-black,
K11 Jacobi or K12 Chebyshev steps), the fused residual + P^T restriction
(K2; with injection or full weighting the residual K10 and the plain
transfer), the recursion with a zero initial guess down to the
factorised coarse solve (once for V, twice for W; F runs an F recursion
and then a V-cycle), the fused prolongation + correction (K3; with 'p1'
the plain embedding and an add) and ν2 sweeps.  As in the JAX package,
an f32 red-black V-cycle runs the levels at and below TAIL_MAX_LM as the
fused coarse tail: the down leg (K13), the coarse solve and the up leg
(K14), two launches in all.  CycleSpec.fusion fuses a 3D const-7
red-black level's steps (cycle_fusion): "rb2" runs sweep pairs as K35,
"rb_restrict" the last pre-smoothing sweep with the restriction as K36,
"prolong_rb" the correction with the first post-smoothing sweep as K37.
A 3D stored-planes level (variable kappa, Galerkin) runs ν1 sweeps (K17
multicolour GS or K16 Jacobi), the residual (K15) and its P^T
restriction (K18) in two steps, the recursion, the correction through K3
and ν2 sweeps; a 3D P2 parity level the same with K20 snap-Jacobi sweeps
and the residual K19.  In 2D a level runs ν1 sweeps (K5 Jacobi, K6
red-black or Chebyshev on K7; on stored planes K23 Jacobi or K24
multicolour GS), the residual (K7; K22 on planes), its restriction (K8
for 'pt', the plain transfer otherwise), the recursion, v + P(vc) through
K9 ('p1': the plain embedding; the JAX package has no fused 2D
correction) and ν2 sweeps.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import CycleSpec
from ..ops import dispatch, transfer
from ..ops.smoothers import smooth
from .hierarchy import Hierarchy

#: Top level size of the fused coarse tail (the JAX package's
#: stencil3d_tail.tail_max_lm() default).
TAIL_MAX_LM = 65


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
    'injection' (a strided copy) and 'full_weighting' (the reference's
    1/4^d weighting) as plain transfers, 2D and 3D.  'pt' is the pure
    correction equation: the error vanishes at Dirichlet nodes, so the
    kernels mask the fine boundary residual out and zero the coarse
    boundary.  'injection' and 'full_weighting' carry the boundary
    residual through, as the reference does."""
    if kind == "pt":
        if r.ndim == 3:
            return dispatch.restrict_pt(r, lv.n + 1, lv_c.n + 1)
        return dispatch.restrict_pt_2d(r, lv.n + 1, lv_c.n + 1)
    return transfer.restrict(r, kind)


def prolong_level(vc: torch.Tensor, fine_level, v: torch.Tensor = None,
                  kind: str = "bilinear") -> torch.Tensor:
    """P(vc), or the correction v + P(vc) when v is given.  'bilinear':
    K3 (fused with the add) in 3D, K9 and then the add in 2D; 'p1': the
    plain P1 embedding on the fine level's diagonal, then the add."""
    lmf = fine_level.n + 1
    if kind == "p1":
        e = transfer.prolong_p1(vc, fine_level.diagonal)
    elif vc.ndim == 2:
        e = dispatch.prolong_linear_2d(vc, lmf)
    else:
        return dispatch.prolong_linear(vc, lmf, v)
    return e if v is None else v + e


def _coarse_rhs(lv, lv_c, v, f, spec: CycleSpec) -> torch.Tensor:
    """The coarse right-hand side from the smoothed v: P^T (f - A v) in
    one pass over v and f (K2) on const-7 levels, residual then
    restriction in 2D, on planes levels (K15, K18), on P2 parity levels
    (K19, K18) and for injection and full weighting."""
    if (v.ndim == 2 or spec.restriction != "pt"
            or dispatch.const7_weights(lv.A) is None):
        return restrict_level(compute_residual(lv, v, f), lv, lv_c,
                              spec.restriction)
    wc, woff = dispatch.const7_weights(lv.A)
    return dispatch.restrict_residual_pt(v, f, lv.n + 1, lv_c.n + 1, wc, woff)


def cycle_fusion(lv, spec: CycleSpec, collect_debug: bool):
    """The members of spec.fusion that level lv admits, and its const-7
    weights: red-black smoothing, 'pt' restriction, bilinear
    prolongation, a 3D const-7 level and no debug collection (the JAX
    package's _cycle_fuse_ok without its TPU layout checks).  ((), None)
    when none applies."""
    if not spec.fusion or collect_debug or spec.smoother != "rbgs":
        return (), None
    if spec.restriction != "pt" or spec.prolongation != "bilinear":
        return (), None
    w = dispatch.const7_weights(lv.A) if lv.b.ndim == 3 else None
    return (spec.fusion, w) if w is not None else ((), None)


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
    """One cycle (V, W or F by spec.cycle) at level index `lidx` (0 =
    coarsest) from initial guess v with right-hand side f.  With
    collect_debug=True also returns (restricted residual, coarse error,
    interpolated correction), with the correction prolonged and added in
    two steps."""
    if lidx == 0:
        u = hier.coarse.solve(f)
        return (u, None) if collect_debug else u
    lv = hier.levels[lidx]
    lv_c = hier.levels[lidx - 1]
    fused, w = cycle_fusion(lv, spec, collect_debug)
    rb2 = "rb2" in fused
    if "rb_restrict" in fused and spec.nu1 >= 1:
        v = smooth(lv.sm, lv.A, v, f, spec.nu1 - 1, spec.smoother, rb2=rb2)
        v, fc = dispatch.rb_residual_restrict(v, f, lv.n + 1, lv_c.n + 1,
                                              *w)
    else:
        v = smooth(lv.sm, lv.A, v, f, spec.nu1, spec.smoother, rb2=rb2)
        fc = _coarse_rhs(lv, lv_c, v, f, spec)
    if spec.cycle == "V" or lidx == 1:
        vc = tail_or_recurse(hier, spec, lidx - 1, fc)
    elif spec.cycle == "W":
        vc = vcycle(hier, spec, lidx - 1, torch.zeros_like(fc), fc)
        vc = vcycle(hier, spec, lidx - 1, vc, fc)
    else:
        vc = vcycle(hier, spec, lidx - 1, torch.zeros_like(fc), fc)
        vc = vcycle(hier, dataclasses.replace(spec, cycle="V"), lidx - 1, vc,
                    fc)
    if collect_debug:
        e = prolong_level(vc, lv, kind=spec.prolongation)
        v = smooth(lv.sm, lv.A, v + e, f, spec.nu2, spec.smoother)
        return v, (fc, vc, e)
    nu2 = spec.nu2
    if "prolong_rb" in fused and nu2 >= 1:
        v = dispatch.prolong_correct_rb(vc, v, f, lv.n + 1, *w)
        nu2 -= 1
    else:
        v = prolong_level(vc, lv, v, spec.prolongation)
    return smooth(lv.sm, lv.A, v, f, nu2, spec.smoother, rb2=rb2)
