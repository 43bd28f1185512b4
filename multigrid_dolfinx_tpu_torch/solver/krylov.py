"""Multigrid-preconditioned (flexible) conjugate gradients of the port.

Mirrors `multigrid_dolfinx_tpu.solver.krylov` (BASELINE.json config 5):
CG on the finest level with one V-cycle from a zero guess as the
preconditioner and the flexible (Polak-Ribiere) beta, which keeps CG
robust to a V-cycle that is not exactly symmetric (red-black GS).
PyTorch runs eagerly, so the JAX while_loop becomes a host loop with one
scalar read per iteration (the residual norm), as `fmg.tolerance_solve`.
The dot products are `torch.sum` in the solve's dtype, as the JAX
package's `jnp.sum`; alpha and beta stay 0-d tensors on the device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import CycleSpec
from .fmg import check_norm, fmg_ramp
from .hierarchy import Hierarchy
from .vcycle import check_slice, compute_residual, vcycle


class CGResult(NamedTuple):
    """Solution and convergence telemetry.  res_hist is the (max_cycles,)
    FEM-L2 residual per iteration on the hierarchy's device, NaN beyond
    num_iters; num_iters, converged and diverged are host values."""

    u: torch.Tensor
    res_hist: torch.Tensor
    num_iters: int
    converged: bool
    diverged: bool


def apply_operator(level, p: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """A p = -(0 - A p): the residual kernel (K10 in 3D, K7 in 2D, K15 /
    K22 on 3D / 2D planes, K19 on P2) on the zero right-hand side `zero`;
    identity rows give p exactly.  The JAX
    package forms A p as p - r(p, p), which rounds r = p - A p to the
    solve's dtype first.  For the smoothest modes |A p| ~ 3 pi^2 h^3 |p|
    in 3D (2.2e-7 |p| at 512^3, a few f32 ulps of |p|), so in f32 that
    loses the smooth part of A p, and MG-CG from zero stops with a smooth
    error that the rtol check cannot see."""
    return compute_residual(level, p, zero).neg_()


def mgcg_solve(hier: Hierarchy, spec: CycleSpec,
               fmg_start: bool = True) -> CGResult:
    """Flexible MG-preconditioned CG on the finest level.

    fmg_start=True seeds CG with one fixed-mode Full-Multigrid pass
    (mu0 = 1 on every level), so the Krylov loop starts at the
    discretisation error; else CG starts from zero.  A p is
    apply_operator's -r(p, 0).  After every iteration the check ||b - A x||_M
    (fmg.check_norm: K4 in 3D) stops the loop at rn <= tol or rn <= rtol *
    ||b - A 0||_M (rtol > 0); a non-finite rn stops it as diverged."""
    check_slice(spec)
    L = hier.num_levels - 1
    lv = hier.finest
    f = lv.b
    np_dtype = np.float32 if f.dtype == torch.float32 else np.float64
    max_it = spec.max_cycles

    if fmg_start and hier.num_levels > 1:
        x = fmg_ramp(hier, dataclasses.replace(spec, mu0=1))[0]
    else:
        x = torch.zeros_like(f)

    def precond(r):
        return vcycle(hier, spec, L, torch.zeros_like(r), r)

    zero = torch.zeros_like(f)

    def apply_A(p):
        return apply_operator(lv, p, zero)

    r = compute_residual(lv, x, f)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    hist = torch.full((max_it,), float("nan"), dtype=f.dtype, device=f.device)
    # thresholds in the solve's dtype, as the JAX loop forms them
    tol = np_dtype(spec.tol)
    rtol_thr = None
    if spec.rtol > 0.0:
        rtol_thr = np_dtype(spec.rtol) * np_dtype(
            check_norm(hier, torch.zeros_like(f), f).item())
    k, converged, diverged = 0, False, False
    while not converged and not diverged and k < max_it:
        Ap = apply_A(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        # flexible (Polak-Ribiere) beta: z_new . (r_new - r) / rz
        beta = torch.sum(z * (r_new - r)) / rz
        p = z + beta * p
        rz = torch.sum(r_new * z)
        r = r_new
        rn_t = check_norm(hier, x, f)
        hist[k] = rn_t
        rn = np_dtype(rn_t.item())
        converged = bool(rn <= tol) or (rtol_thr is not None
                                        and bool(rn <= rtol_thr))
        diverged = not bool(np.isfinite(rn))
        k += 1
    return CGResult(u=x, res_hist=hist, num_iters=k, converged=converged,
                    diverged=diverged)



#: The JAX package's solve_mgcg adds a TPU size guard and a jit switch to
#: mgcg_solve; the port needs neither, so the two names are one function.
solve_mgcg = mgcg_solve
