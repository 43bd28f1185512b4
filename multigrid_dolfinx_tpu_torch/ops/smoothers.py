"""Smoothers of the port: red-black Gauss-Seidel (const-7 in 3D, const-5
in 2D) and weighted Jacobi (const-5, the reference's smoother).

Each sweep goes through ops.dispatch (a kernel on CUDA, its plain version
on the CPU): 3D RB-GS through K1, 2D RB-GS through K6, 2D Jacobi through
K5.  Contracts the error norm, the FMG ramp and the reference's cycle
counts rely on: after every GS sweep, boundary rows hold exactly f;
Jacobi mixes them, (1-w) v + w f (the reference's jacobiRelaxation with
identity rows).  3D Jacobi waits for its kernel (ROADMAP.md queue 2,
item 4); Chebyshev is queue 1, item 13.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import dispatch
from .operators import StencilOperator


@dataclasses.dataclass(frozen=True)
class SmootherData:
    """Per-level smoother parameters: lmax, the largest eigenvalue of
    Dinv*A (exact for the Dirichlet const stencil; read by the Chebyshev
    smoother of a later item), the Jacobi weight omega, and dinv = 1/diag
    A as stored by the assembled build (None: taken from the const
    operator, which stores nothing grid-sized)."""

    lmax: float
    omega: float
    dinv: Optional[torch.Tensor] = None

    def dinv_for(self, A: StencilOperator, like: torch.Tensor) -> torch.Tensor:
        if self.dinv is not None:
            return self.dinv
        return A.dinv(like.dtype, like.device)


def smooth(sm: SmootherData, A: StencilOperator, v: torch.Tensor,
           f: torch.Tensor, nsweeps: int, kind: str) -> torch.Tensor:
    if nsweeps <= 0:
        return v
    if kind == "chebyshev":
        raise NotImplementedError(
            "smoother 'chebyshev' is ROADMAP.md queue 1, item 13")
    lm = A.logical_m
    if v.ndim == 2:
        dispatch.require_const5(A)
        if kind == "jacobi":
            df = sm.dinv_for(A, f) * f      # hoisted once per call
            for _ in range(nsweeps):
                v = dispatch.jacobi_sweep_2d(v, df, lm, sm.omega)
            return v
        for _ in range(nsweeps):
            v = dispatch.rb_sweep_2d(v, f, lm)
        return v
    if kind == "jacobi":
        raise NotImplementedError(
            "3D weighted Jacobi needs stencil3d.jacobi_sweep, ROADMAP.md "
            "queue 2, item 4")
    w = dispatch.const7_weights(A)
    if w is None:
        raise NotImplementedError(
            "red-black GS of non-const-7 operators is ROADMAP.md queue 1, "
            "item 14")
    for _ in range(nsweeps):
        v = dispatch.rb_sweep(v, f, lm, w[0], w[1])
    return v
