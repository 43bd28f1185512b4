"""The V-cycle of the port, run eagerly level by level.

Mirrors `multigrid_dolfinx_tpu.solver.vcycle` on its per-level path: every
level, the coarse ones included, runs the same kernels — ν1 red-black
sweeps (K1), the fused residual + P^T restriction (K2), the recursion with
a zero initial guess down to the factorised coarse solve, the fused
prolongation + correction (K3), ν2 sweeps.  The JAX package's fused coarse
tail (levels <= 65^3 in two kernels) is ROADMAP.md queue 2, item 1.
"""
from __future__ import annotations

import torch

from ..config import CycleSpec
from ..ops import dispatch
from ..ops.smoothers import smooth
from .hierarchy import Hierarchy


def check_slice(spec: CycleSpec) -> None:
    """Raise NotImplementedError for cycle options outside the port's
    slice, naming the ROADMAP.md item that brings them."""
    if spec.smoother != "rbgs":
        item = "13" if spec.smoother == "chebyshev" else "6"
        raise NotImplementedError(
            f"smoother {spec.smoother!r} is ROADMAP.md queue 1, item {item}")
    if spec.cycle != "V":
        raise NotImplementedError(
            f"{spec.cycle}-cycles are ROADMAP.md queue 1, item 8")
    if spec.restriction != "pt" or spec.prolongation != "bilinear":
        raise NotImplementedError(
            "transfers other than 'pt' restriction and 'bilinear' "
            "prolongation are ROADMAP.md queue 1, item 5")


def compute_residual(level, v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """r = f - A v (plain torch; the cycle itself never stores r)."""
    return f - level.A.apply(v)


def prolong_level(vc: torch.Tensor, fine_level,
                  v: torch.Tensor = None) -> torch.Tensor:
    """Trilinear P(vc) through kernel K3, or v + P(vc) fused when v is
    given."""
    return dispatch.prolong_linear(vc, fine_level.n + 1, v)


def _residual_restrict(lv, lv_c, v, f) -> torch.Tensor:
    """Coarse RHS P^T (f - A v) in one pass over v and f (kernel K2)."""
    wc, woff = dispatch.const7_weights(lv.A)
    return dispatch.restrict_residual_pt(v, f, lv.n + 1, lv_c.n + 1, wc, woff)


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
    fc = _residual_restrict(lv, lv_c, v, f)
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
