"""Smoothers of the port: red-black Gauss-Seidel for the const-7 operator.

Each sweep goes through ops.dispatch.rb_sweep (kernel K1 on CUDA, its
plain version on the CPU).  GS contract, which the error norm and the FMG
ramp rely on: after every sweep, boundary rows hold exactly f.  Weighted
Jacobi and multicolor GS for other operators are ROADMAP.md queue 1,
item 6; Chebyshev is item 13.
"""
from __future__ import annotations

import dataclasses

import torch

from . import dispatch
from .operators import StencilOperator


@dataclasses.dataclass(frozen=True)
class SmootherData:
    """Per-level smoother parameters: lmax, the largest eigenvalue of
    Dinv*A (exact for the Dirichlet const stencil), and the Jacobi weight
    omega; the Chebyshev and Jacobi smoothers that read them are later
    items."""

    lmax: float
    omega: float


def smooth(sm: SmootherData, A: StencilOperator, v: torch.Tensor,
           f: torch.Tensor, nsweeps: int, kind: str) -> torch.Tensor:
    if nsweeps <= 0:
        return v
    if kind != "rbgs":
        item = "13" if kind == "chebyshev" else "6"
        raise NotImplementedError(
            f"smoother {kind!r} is ROADMAP.md queue 1, item {item}")
    w = dispatch.const7_weights(A)
    if w is None:
        raise NotImplementedError(
            "red-black GS of non-const-7 operators is ROADMAP.md queue 1, "
            "item 14")
    for _ in range(nsweeps):
        v = dispatch.rb_sweep(v, f, A.logical_m, w[0], w[1])
    return v
