"""Static quadrature data for the FEM-L2 error norm (numpy, setup path).

||u_h - u*||^2 = sum_simplices vol sum_q w_q (u_h(x_q) - u*(x_q))^2, with
u*(x_q) evaluated on the fly at norm time (solver.fmg.error_norm): the
data here is O(1) tuples, no grid-sized buffer.  Mirrors
`multigrid_dolfinx_tpu.fem.norms.error_quadrature` for P1 and P2 in 2D
and 3D.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import ProblemSpec
from ..mesh import GridLevel
from . import elements
from .assembly import simplex_vertex_offsets


@dataclasses.dataclass(frozen=True)
class ErrorQuad:
    """voffs[s][a]: lattice offsets of node a of simplex s; lambdas[s][q][a]:
    basis value at quad point q; vw[s][q]: vol_s * w_q; xq_local[s][q]:
    physical offset of quad point q in the cell; h: element size; ncells:
    cells per axis; exact_fn: the manufactured solution; stride: lattice
    points per cell edge (1 for P1, 2 for P2)."""

    voffs: tuple
    lambdas: tuple
    vw: tuple
    xq_local: tuple
    h: float
    ncells: int
    exact_fn: object
    stride: int = 1


def error_quadrature(grid: GridLevel, problem: ProblemSpec) -> ErrorQuad:
    """Per-quadrature-point error-norm data of a 2D or 3D P1 or P2 level;
    `grid` is the element grid (n cells per axis)."""
    h, degree = grid.h, problem.degree
    _, _, measure, (qbary, qw) = elements.simplex_p1(grid.ndim)
    node_fn = elements.simplex_nodes(grid.ndim, degree)
    phi_q = elements.nodal_basis_at(qbary, degree)        # (Q, nb)
    voffs_all, lambdas, vws, xq_locals = [], [], [], []
    for voffs in simplex_vertex_offsets(grid.ndim, problem.diagonal):
        verts = np.asarray([[c * h for c in v] for v in voffs])
        vol = measure(*verts)
        noffs = node_fn(voffs)
        voffs_all.append(tuple(tuple(v) for v in noffs))
        vws.append(tuple(float(vol * qw[q]) for q in range(len(qw))))
        lambdas.append(tuple(tuple(float(phi_q[q, a])
                                   for a in range(len(noffs)))
                             for q in range(len(qw))))
        xq_locals.append(tuple(tuple(float(x) for x in (qbary[q] @ verts))
                               for q in range(len(qw))))
    return ErrorQuad(
        voffs=tuple(voffs_all), lambdas=tuple(lambdas), vw=tuple(vws),
        xq_local=tuple(xq_locals), h=float(h), ncells=int(grid.n),
        exact_fn=problem.resolved_exact(), stride=degree,
    )
