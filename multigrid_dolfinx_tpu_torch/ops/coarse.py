"""Coarsest-grid direct solve: factorised once on the host with scipy,
solved on the device with torch.linalg (a library solve, as the JAX
package left it to XLA).  Mirrors `multigrid_dolfinx_tpu.ops.coarse`,
with one difference: the factor is kept in f64 whatever the hierarchy's
dtype, and the right-hand side is solved in f64 and rounded back.  The
coarsest grid has (n0+1)^3 = 729 unknowns, so this costs nothing, and the
rounded f32 solution is then the same on the CPU and on the card; two f32
triangular solves in different library orders differ by a few ulps, which
the FMG start carries to the finest residual (about 3e-4 relative at
64^3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CoarseSolver:
    """Factorised dense solver for the coarsest level.

    kind='cholesky': factor = lower Cholesky factor of A0 (SPD after the
    symmetric Dirichlet elimination).  kind='lu': factor/piv from LAPACK
    getrf, with scipy's 0-based pivots.  kind='inverse': factor = A0^-1."""

    factor: torch.Tensor          # f64
    piv: Optional[torch.Tensor]
    kind: str
    grid_shape: Tuple[int, ...]

    def solve(self, f_grid: torch.Tensor) -> torch.Tensor:
        f = f_grid.reshape(-1, 1).to(torch.float64)
        if self.kind == "cholesky":
            u = torch.cholesky_solve(f, self.factor, upper=False)
        elif self.kind == "lu":
            # torch takes LAPACK's 1-based pivots
            u = torch.linalg.lu_solve(self.factor, self.piv + 1, f)
        elif self.kind == "inverse":
            u = self.factor @ f
        else:
            raise ValueError(f"unknown coarse solver kind {self.kind!r}")
        return u.reshape(self.grid_shape).to(f_grid.dtype)


def build_coarse_solver(offsets: Sequence[Tuple[int, ...]], planes: np.ndarray,
                        kind: str, device) -> CoarseSolver:
    """Factorise the coarsest stencil operator (numpy/scipy, setup only)."""
    import scipy.linalg

    from ..fem.assembly import stencil_to_csr

    A = stencil_to_csr(offsets, planes).toarray()
    piv = None
    if kind == "cholesky":
        factor = scipy.linalg.cholesky(A, lower=True)
    elif kind == "lu":
        factor, piv = scipy.linalg.lu_factor(A)
    elif kind == "inverse":
        factor = np.linalg.inv(A)
    else:
        raise ValueError(f"unknown coarse solver kind {kind!r}")
    return coarse_solver_from_numpy(factor, piv, kind,
                                    tuple(planes.shape[1:]), device)


def coarse_solver_from_numpy(factor: np.ndarray, piv: Optional[np.ndarray],
                             kind: str, grid_shape: Tuple[int, ...],
                             device) -> CoarseSolver:
    return CoarseSolver(
        factor=torch.tensor(np.asarray(factor), dtype=torch.float64,
                            device=device),
        piv=None if piv is None else torch.tensor(
            np.asarray(piv), dtype=torch.int32, device=device),
        kind=kind,
        grid_shape=tuple(grid_shape),
    )
