"""Coarsest-grid direct solve: factorised once on the host with scipy.
Mirrors `multigrid_dolfinx_tpu.ops.coarse`, with two differences.  The
factor is kept in f64 whatever the hierarchy's dtype, and the right-hand
side is solved in f64 and rounded back.  And kind 'cholesky' solves over
the factor's band in block form (ops/cuda/coarse_band.py): one launch of
kernel K39 on the card, its plain version on the CPU, which agree
bitwise, so the rounded solution is the same on the CPU and on the card.
The dense factor stays on the host.  Kinds 'lu' and 'inverse' are
library solves on the device, as the JAX package left them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import dispatch
from .cuda.coarse_band import BandFactor, band_factor


@dataclasses.dataclass(frozen=True)
class CoarseSolver:
    """Factorised dense solver for the coarsest level.

    kind='cholesky': factor = lower Cholesky factor of A0 (SPD after the
    symmetric Dirichlet elimination), on the host; band = its band in
    block form on the solve's device.  kind='lu': factor/piv from LAPACK
    getrf, with scipy's 0-based pivots.  kind='inverse': factor = A0^-1."""

    factor: torch.Tensor          # f64
    piv: Optional[torch.Tensor]
    kind: str
    grid_shape: Tuple[int, ...]
    band: Optional[BandFactor] = None

    def solve(self, f_grid: torch.Tensor) -> torch.Tensor:
        if self.kind == "cholesky":
            return dispatch.coarse_band_solve(
                f_grid, self.band).reshape(self.grid_shape)
        f = f_grid.reshape(-1, 1).to(torch.float64)
        if self.kind == "lu":
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
    shape = planes.shape[1:]
    strides = np.cumprod((1,) + shape[:0:-1])[::-1]     # C order
    w = max(abs(int(np.dot(o, strides))) for o in offsets)
    if kind == "cholesky":
        factor = scipy.linalg.cholesky(A, lower=True)
    elif kind == "lu":
        factor, piv = scipy.linalg.lu_factor(A)
    elif kind == "inverse":
        factor = np.linalg.inv(A)
    else:
        raise ValueError(f"unknown coarse solver kind {kind!r}")
    return coarse_solver_from_numpy(factor, piv, kind,
                                    tuple(planes.shape[1:]), device, w)


def coarse_solver_from_numpy(factor: np.ndarray, piv: Optional[np.ndarray],
                             kind: str, grid_shape: Tuple[int, ...],
                             device, w: Optional[int] = None
                             ) -> CoarseSolver:
    """A solver from a factor as `build_coarse_solver` makes it.  For
    'cholesky' the band's half-width is the factor's own; an entry
    beyond `w`, where given, raises."""
    if kind == "cholesky":
        factor = np.asarray(factor, dtype=np.float64)
        if not factor.flags.writeable:
            factor = factor.copy()
        return CoarseSolver(factor=torch.from_numpy(factor), piv=None,
                            kind=kind, grid_shape=tuple(grid_shape),
                            band=band_factor(factor, device, w))
    return CoarseSolver(
        factor=torch.tensor(np.asarray(factor), dtype=torch.float64,
                            device=device),
        piv=None if piv is None else torch.tensor(
            np.asarray(piv), dtype=torch.int32, device=device),
        kind=kind,
        grid_shape=tuple(grid_shape),
    )
