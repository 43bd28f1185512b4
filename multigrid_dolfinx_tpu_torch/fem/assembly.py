"""Ahead-of-time P1 assembly on the Kuhn-tetrahedra grid -> stencil planes
(numpy, setup path only).

The P1 numpy path of `multigrid_dolfinx_tpu.fem.assembly`, triangles in
2D and Kuhn tetrahedra in 3D: the operator at node p is
(A u)[p] = sum_k planes[k][p] * u[p + offsets[k]], with dolfinx's
Dirichlet semantics (symmetric elimination, lifting, set_bc).  Lean
hierarchies assemble only the tiny prototype and coarsest grids with it
(the fine levels are built on the device, fem.fast_const); the assembled
`build_hierarchy` assembles every level.  The native C++ assembler of the
JAX package (`csrc/`) is not used here.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..config import ProblemSpec
from ..mesh import GridLevel
from . import elements

Offset = Tuple[int, ...]


def simplex_vertex_offsets(ndim: int, diagonal: str = "right") -> List[List[Offset]]:
    """Vertex offsets (integer corner coordinates of the unit cell) of each
    simplex of one cell.  2D: two triangles split along the (0,0)-(1,1)
    diagonal ('right') or (1,0)-(0,1) ('left').  3D: the Kuhn/Freudenthal
    split into 6 tetrahedra
    sharing the (0,0,0)-(1,1,1) diagonal ('right') or its mirror in the
    first axis, (1,0,0)-(0,1,1) ('left')."""
    if ndim == 2:
        if diagonal == "right":
            return [[(0, 0), (1, 0), (1, 1)], [(0, 0), (1, 1), (0, 1)]]
        if diagonal == "left":
            return [[(0, 0), (1, 0), (0, 1)], [(1, 0), (1, 1), (0, 1)]]
        raise ValueError(f"bad diagonal {diagonal!r}")
    if ndim != 3:
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    simplices = []
    for perm in itertools.permutations(range(3)):
        v = [(0, 0, 0)]
        cur = [0, 0, 0]
        for axis in perm:
            cur = list(cur)
            cur[axis] = 1
            v.append(tuple(cur))
        simplices.append(v)
    if diagonal == "left":
        simplices = [[(1 - vx, vy, vz) for (vx, vy, vz) in s] for s in simplices]
    elif diagonal != "right":
        raise ValueError(f"bad diagonal {diagonal!r}")
    return simplices


class PlaneAccumulator:
    """Accumulates element-matrix entries into {offset: plane} arrays."""

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = shape
        self.planes: Dict[Offset, np.ndarray] = {}

    def add(self, row_voff: Offset, col_voff: Offset, value, n: int):
        off = tuple(c - r for r, c in zip(row_voff, col_voff))
        if off not in self.planes:
            self.planes[off] = np.zeros(self.shape, dtype=np.float64)
        slab = tuple(slice(r, r + n) for r in row_voff)
        self.planes[off][slab] += value

    def finalize(self) -> Tuple[Tuple[Offset, ...], np.ndarray]:
        """Sorted (offsets, planes) with numerically zero planes dropped
        (relative threshold: the diagonal couplings of the isotropic Kuhn
        Laplacian cancel exactly, leaving ~1e-17 summation dust)."""
        zero = (0,) * len(self.shape)
        self.planes.setdefault(zero, np.zeros(self.shape))
        amax = {o: float(np.abs(p).max()) for o, p in self.planes.items()}
        tol = 1e-13 * max(max(amax.values(), default=1.0), 1e-300)
        offs = [o for o in sorted(self.planes)
                if o == zero or amax[o] > tol]
        planes = np.stack([self.planes[o] for o in offs], axis=0)
        planes[np.abs(planes) <= tol] = 0.0
        return tuple(offs), planes


def stencil_apply_np(offsets: Sequence[Offset], planes: np.ndarray,
                     u: np.ndarray) -> np.ndarray:
    """Numpy stencil matvec (setup time)."""
    r = max(max(abs(c) for c in off) for off in offsets)
    up = np.pad(u, r)
    out = np.zeros_like(u)
    for k, off in enumerate(offsets):
        sl = tuple(slice(r + o, r + o + s) for o, s in zip(off, u.shape))
        out += planes[k] * up[sl]
    return out


def stencil_to_csr(offsets: Sequence[Offset], planes: np.ndarray):
    """Stencil planes -> scipy CSR (coarse-solve factorisation)."""
    import scipy.sparse as sp

    shape = planes.shape[1:]
    size = int(np.prod(shape))
    flat_index = np.arange(size).reshape(shape)
    rows, cols, vals = [], [], []
    for k, off in enumerate(offsets):
        src = tuple(slice(max(0, -o), min(s, s - o)) for o, s in zip(off, shape))
        dst = tuple(slice(max(0, o), min(s, s + o)) for o, s in zip(off, shape))
        v = planes[k][src]
        nz = v != 0.0
        rows.append(flat_index[src][nz])
        cols.append(flat_index[dst][nz])
        vals.append(v[nz])
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(size, size))


@dataclasses.dataclass
class AssembledLevel:
    """One assembled level as numpy arrays (BC-eliminated A, raw A, full
    mass M, lifted RHS b, Dirichlet values g, interior mask)."""

    grid: GridLevel
    offsets: Tuple[Offset, ...]
    A_planes: np.ndarray
    A_raw_planes: np.ndarray
    M_offsets: Tuple[Offset, ...]
    M_planes: np.ndarray
    b: np.ndarray
    g: np.ndarray
    interior: np.ndarray


def assemble_level(grid: GridLevel, problem: ProblemSpec) -> AssembledLevel:
    """Assemble P1 stiffness, mass and load for one 2D or 3D level with
    dolfinx's Dirichlet semantics: symmetric elimination with unit
    diagonal, b <- b - A_raw g (apply_lifting), b <- uD on the boundary
    (set_bc)."""
    if problem.degree != 1 or problem.kappa is not None:
        raise NotImplementedError(
            "the port assembles constant-coefficient P1 only; P2 and "
            "variable kappa are ROADMAP.md queue 1, items 16 and 14")
    ndim, n, h = grid.ndim, grid.n, grid.h
    shape = grid.shape
    acc_a = PlaneAccumulator(shape)
    acc_m = PlaneAccumulator(shape)
    b = np.zeros(shape, dtype=np.float64)
    rhs_fn = problem.resolved_rhs()
    stiffness, mass, measure, (qbary, qw) = elements.simplex_p1(ndim)
    cell_axes = [np.arange(n, dtype=np.float64) * h for _ in range(ndim)]
    cell_origin = np.meshgrid(*cell_axes, indexing="ij")

    for voffs in simplex_vertex_offsets(ndim, problem.diagonal):
        verts = np.asarray([[c * h for c in v] for v in voffs])
        K = stiffness(*verts)
        M = mass(*verts)
        vol = measure(*verts)
        for a in range(ndim + 1):
            for bb in range(ndim + 1):
                acc_a.add(voffs[a], voffs[bb], K[a, bb], n)
                acc_m.add(voffs[a], voffs[bb], M[a, bb], n)
        for q in range(len(qw)):
            xq_local = qbary[q] @ verts
            fq = rhs_fn(*[co + xo for co, xo in zip(cell_origin, xq_local)])
            for a in range(ndim + 1):
                slab = tuple(slice(r, r + n) for r in voffs[a])
                b[slab] += vol * qw[q] * qbary[q, a] * fq

    offsets, a_raw = acc_a.finalize()
    m_offsets, m_planes = acc_m.finalize()
    interior = grid.interior_mask()
    boundary = ~interior
    g = np.where(boundary, problem.resolved_exact()(*grid.coords()), 0.0)
    b = b - stencil_apply_np(offsets, a_raw, g)
    b = np.where(boundary, g, b)
    return AssembledLevel(
        grid=grid, offsets=offsets,
        A_planes=eliminate_dirichlet_np(offsets, a_raw, interior),
        A_raw_planes=a_raw, M_offsets=m_offsets, M_planes=m_planes,
        b=b, g=g, interior=interior,
    )


def assemble_hierarchy(grids: Sequence[GridLevel],
                       problem: ProblemSpec) -> List[AssembledLevel]:
    """Assemble every level (rediscretisation, as the reference does)."""
    return [assemble_level(g, problem) for g in grids]


def eliminate_dirichlet_np(offsets, raw_planes: np.ndarray,
                           interior: np.ndarray) -> np.ndarray:
    """Symmetric Dirichlet elimination: zero bc rows and columns, unit
    diagonal on bc rows."""
    shape = interior.shape
    zero = (0,) * len(shape)
    r = max(max(abs(c) for c in off) for off in offsets)
    ipad = np.pad(interior, r, constant_values=False)
    planes = raw_planes.copy()
    for k, off in enumerate(offsets):
        sl = tuple(slice(r + o, r + o + s) for o, s in zip(off, shape))
        planes[k] *= interior & ipad[sl]
    center = tuple(offsets).index(zero)
    planes[center] = np.where(interior, planes[center], 1.0)
    return planes
