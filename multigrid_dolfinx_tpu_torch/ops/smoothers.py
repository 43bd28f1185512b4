"""Smoothers of the port: red-black Gauss-Seidel, weighted Jacobi and
Chebyshev polynomial smoothing, on the const-7 (3D) and const-5 (2D)
operators; multicolour Gauss-Seidel and weighted Jacobi on 3D and 2D
stored-planes operators; weighted Jacobi on the 3D P2 parity operator.

Each sweep goes through ops.dispatch (a kernel on CUDA, its plain version
on the CPU): 3D RB-GS through K1, 3D Jacobi through K11, 3D Chebyshev
through the fused momentum-form step K12; 2D RB-GS through K6, 2D Jacobi
through K5, 2D Chebyshev in p-form on the residual K7; on planes,
multicolour GS through K17 and Jacobi through K16 in 3D, K24 and K23
in 2D; on P2, Jacobi through K20.  Contracts the error norm, the FMG
ramp and the reference's cycle counts rely on: after every GS sweep,
boundary rows hold exactly f;
Jacobi mixes them, (1-w) v + w f (the reference's jacobiRelaxation with
identity rows), except on P2, whose Jacobi snaps them to f on every sweep
(the JAX package's snap contract: the residual then vanishes on every
face at each post-sweep check); Chebyshev adds b (f - v) there (dinv = 1
on identity rows), as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import dispatch
from .operators import StencilOperator

NP_TYPES = {torch.float32: np.float32, torch.float64: np.float64}
#: lmax / lmin of the Chebyshev window, as every build of the JAX package
#: sets it (hierarchy.py cheby_eig_ratio=4.0).
CHEBY_EIG_RATIO = 4.0


@dataclasses.dataclass(frozen=True)
class SmootherData:
    """Per-level smoother parameters: lmax, the largest eigenvalue of
    Dinv*A (exact for the Dirichlet const stencil; it sets the Chebyshev
    window), the Jacobi weight omega, dinv = 1/diag A as stored by the
    assembled build (None: taken from the operator; a const one stores
    nothing grid-sized, the planes kernels read the centre plane) and the
    Chebyshev degree convention (see
    cheby_phase)."""

    lmax: float
    omega: float
    dinv: Optional[torch.Tensor] = None
    cheby_degree: int = 0

    def dinv_for(self, A: StencilOperator, like: torch.Tensor) -> torch.Tensor:
        if self.dinv is not None:
            return self.dinv
        return A.dinv(like.dtype, like.device)


def cheby_phase(nsweeps: int, cheby_degree: int):
    """(rounds, degree) of a Chebyshev smoothing phase asked for `nsweeps`
    sweeps.  cheby_degree == 0 (the default): ONE polynomial of degree
    `nsweeps` (nu matvecs, the budget of nu Jacobi/GS sweeps);
    cheby_degree d > 0: `nsweeps` applications of a degree-d polynomial."""
    if cheby_degree <= 0:
        return (1, int(nsweeps)) if nsweeps > 0 else (0, 1)
    return int(nsweeps), int(cheby_degree)


def cheby_window(sm: SmootherData, dtype: torch.dtype):
    """(theta, delta, sigma) of the window [lmax/CHEBY_EIG_RATIO, lmax] with
    lmax = 1.05 sm.lmax, as numpy scalars of the solve's dtype formed in
    the JAX package's order (an f32 solve rounds each step to f32)."""
    t = NP_TYPES[dtype]
    lmax = t(sm.lmax) * t(1.05)
    lmin = lmax / t(CHEBY_EIG_RATIO)
    theta = t(0.5) * (lmax + lmin)
    delta = t(0.5) * (lmax - lmin)
    return theta, delta, theta / delta


def chebyshev_smooth(sm: SmootherData, A: StencilOperator, v: torch.Tensor,
                     f: torch.Tensor, nsweeps: int) -> torch.Tensor:
    """Chebyshev smoothing of Dinv*A in p-form on the 2D const-5 operator
    (the JAX package's chebyshev_smooth with its residual kernel K7)."""
    rounds, degree = cheby_phase(nsweeps, sm.cheby_degree)
    theta, delta, sigma = cheby_window(sm, v.dtype)
    one, two = type(theta)(1.0), type(theta)(2.0)
    dinv = sm.dinv_for(A, f)
    lm = A.logical_m
    for _ in range(rounds):
        p = (dinv * dispatch.residual_2d(v, f, lm)) / float(theta)
        v = v + p
        rho_prev = one / sigma
        for _ in range(1, degree):
            z = dinv * dispatch.residual_2d(v, f, lm)
            rho = one / (two * sigma - rho_prev)
            p = float(rho * rho_prev) * p + float(two * rho / delta) * z
            v = v + p
            rho_prev = rho
    return v


def chebyshev_phase(sm: SmootherData, A: StencilOperator, v: torch.Tensor,
                    f: torch.Tensor, nsweeps: int) -> torch.Tensor:
    """The same polynomial in momentum form on the fused step K12 (the JAX
    package's chebyshev_phase_fused): v_{k+1} = v_k + a_k (v_k - v_{k-1})
    + b_k Dinv (f - A v_k), a_0 = 0, b_0 = 1/theta, then a_k = rho_k
    rho_{k-1}, b_k = 2 rho_k / delta.  Run on every 3D level: the JAX
    admission rule answers TPU tiling only."""
    wc, woff = _const7(A)
    lm = A.logical_m
    rounds, degree = cheby_phase(nsweeps, sm.cheby_degree)
    theta, delta, sigma = cheby_window(sm, v.dtype)
    one, two = type(theta)(1.0), type(theta)(2.0)
    for _ in range(rounds):
        vp = v
        v = dispatch.cheby_step(v, v, f, lm, wc, woff, 0.0,
                                float(one / theta))
        rho_prev = one / sigma
        for _ in range(1, degree):
            rho = one / (two * sigma - rho_prev)
            vp, v = v, dispatch.cheby_step(v, vp, f, lm, wc, woff,
                                           float(rho * rho_prev),
                                           float(two * rho / delta))
            rho_prev = rho
    return v


def _const7(A: StencilOperator):
    w = dispatch.const7_weights(A)
    if w is None:
        raise NotImplementedError(
            "3D const operators other than the 7-point stencil have no "
            "kernel; stored-planes operators (build_var_hierarchy) smooth "
            "through K16/K17")
    return w


def smooth_planes(sm: SmootherData, A: StencilOperator, v: torch.Tensor,
                  f: torch.Tensor, nsweeps: int, kind: str) -> torch.Tensor:
    """Sweeps on a stored-planes operator: multicolour GS (K17 in 3D, K24
    in 2D, the colours of planes3_colors / planes2_colors, in place on one
    copy of v a phase) or weighted Jacobi (K16 in 3D, K23 in 2D, out of
    place in two buffers), d = 1/P_c from the centre plane.  The caller's
    v is never written."""
    if kind == "chebyshev":
        raise NotImplementedError(
            "Chebyshev smoothing on stored-planes operators needs the "
            "power-iteration lmax, ROADMAP.md queue 1, item 19")
    if v.ndim == 2:
        jacobi_sweep, gs_sweep = (dispatch.planes2_jacobi_sweep,
                                  dispatch.planes2_gs_sweep)
    else:
        jacobi_sweep, gs_sweep = (dispatch.planes3_jacobi_sweep,
                                  dispatch.planes3_gs_sweep)
    if kind == "jacobi":
        bufs = [torch.empty_like(v) for _ in range(min(nsweeps, 2))]
        for k in range(nsweeps):
            v = jacobi_sweep(v, f, A.planes, A.offsets, sm.omega,
                             out=bufs[k % 2])
        return v
    v = v.clone()
    for _ in range(nsweeps):
        gs_sweep(v, f, A.planes, A.offsets)
    return v


def smooth_p2(sm: SmootherData, A: StencilOperator, v: torch.Tensor,
              f: torch.Tensor, nsweeps: int, kind: str) -> torch.Tensor:
    """Snap weighted-Jacobi sweeps on the P2 parity operator (K20), out of
    place in two buffers; the caller's v is never written."""
    if kind == "chebyshev":
        raise NotImplementedError(
            "Chebyshev smoothing on P2 needs the power-iteration lmax "
            "(fast_p2.py device_p2_lmax), ROADMAP.md queue 1, item 19")
    if kind != "jacobi":
        raise NotImplementedError(
            "multicolour (27-colour) Gauss-Seidel on P2 is ROADMAP.md "
            "queue 1, item 22")
    bufs = [torch.empty_like(v) for _ in range(min(nsweeps, 2))]
    for k in range(nsweeps):
        v = dispatch.p2_jacobi_sweep(v, f, A.parity_tables, A.offsets,
                                     sm.omega, out=bufs[k % 2])
    return v


def smooth(sm: SmootherData, A: StencilOperator, v: torch.Tensor,
           f: torch.Tensor, nsweeps: int, kind: str) -> torch.Tensor:
    if nsweeps <= 0:
        return v
    if A.parity_tables is not None:
        return smooth_p2(sm, A, v, f, nsweeps, kind)
    if A.planes is not None:
        return smooth_planes(sm, A, v, f, nsweeps, kind)
    lm = A.logical_m
    if v.ndim == 2:
        dispatch.require_const5(A)
        if kind == "chebyshev":
            return chebyshev_smooth(sm, A, v, f, nsweeps)
        if kind == "jacobi":
            df = sm.dinv_for(A, f) * f      # hoisted once per call
            for _ in range(nsweeps):
                v = dispatch.jacobi_sweep_2d(v, df, lm, sm.omega)
            return v
        for _ in range(nsweeps):
            v = dispatch.rb_sweep_2d(v, f, lm)
        return v
    if kind == "chebyshev":
        return chebyshev_phase(sm, A, v, f, nsweeps)
    wc, woff = _const7(A)
    if kind == "jacobi":
        # out of place, ping-ponging two buffers: the caller's v is never
        # written (FMG and the V-cycle reuse it)
        bufs = [torch.empty_like(v) for _ in range(min(nsweeps, 2))]
        for k in range(nsweeps):
            v = dispatch.jacobi_sweep(v, f, lm, wc, woff, sm.omega,
                                      out=bufs[k % 2])
        return v
    for _ in range(nsweeps):
        v = dispatch.rb_sweep(v, f, lm, wc, woff)
    return v
