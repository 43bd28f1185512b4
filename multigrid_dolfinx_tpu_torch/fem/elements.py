"""P1 triangle and tetrahedron element matrices and quadrature (numpy,
setup path only).

The P1 subset of `multigrid_dolfinx_tpu.fem.elements` that the 2D and 3D
assembly and norms use; the P2 pieces come with the P2 slice (ROADMAP.md
queue 1, item 16).
"""
from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np


def triangle_area(p0, p1, p2) -> float:
    return 0.5 * abs(
        (p1[0] - p0[0]) * (p2[1] - p0[1]) - (p2[0] - p0[0]) * (p1[1] - p0[1])
    )


def p1_triangle_stiffness(p0, p1, p2) -> np.ndarray:
    """3x3 P1 stiffness on a triangle: (e_a . e_b) / (4 area), e_a the edge
    opposite vertex a."""
    p = np.asarray([p0, p1, p2], dtype=np.float64)
    e = np.asarray([p[(a + 2) % 3] - p[(a + 1) % 3] for a in range(3)])
    area = triangle_area(p0, p1, p2)
    grads = np.stack([-e[:, 1], e[:, 0]], axis=1) / (2.0 * area)
    return area * (grads @ grads.T)


def p1_triangle_mass(p0, p1, p2) -> np.ndarray:
    """3x3 consistent P1 mass matrix = area/12 * (1 + delta_ab)."""
    area = triangle_area(p0, p1, p2)
    return (area / 12.0) * (np.ones((3, 3)) + np.eye(3))


# Dunavant 7-point rule, exact through degree 5 on the triangle
# (barycentric points, weights summing to 1).
_DUNAVANT7_BARY = np.array([
    [1.0 / 3.0, 1.0 / 3.0, 1.0 / 3.0],
    [0.797426985353087, 0.101286507323456, 0.101286507323456],
    [0.101286507323456, 0.797426985353087, 0.101286507323456],
    [0.101286507323456, 0.101286507323456, 0.797426985353087],
    [0.059715871789770, 0.470142064105115, 0.470142064105115],
    [0.470142064105115, 0.059715871789770, 0.470142064105115],
    [0.470142064105115, 0.470142064105115, 0.059715871789770],
])
_DUNAVANT7_W = np.array([0.225] + [0.125939180544827] * 3
                        + [0.132394152788506] * 3)


def triangle_quadrature() -> Tuple[np.ndarray, np.ndarray]:
    """(barycentric points (Q,3), weights (Q,) summing to 1)."""
    return _DUNAVANT7_BARY, _DUNAVANT7_W


def tet_volume(p0, p1, p2, p3) -> float:
    p = np.asarray([p0, p1, p2, p3], dtype=np.float64)
    return abs(np.linalg.det(p[1:] - p[0])) / 6.0


def p1_tet_stiffness(p0, p1, p2, p3) -> np.ndarray:
    """4x4 P1 stiffness on a tetrahedron (closed form via barycentric
    gradients)."""
    p = np.asarray([p0, p1, p2, p3], dtype=np.float64)
    vol = tet_volume(p0, p1, p2, p3)
    amat = np.hstack([np.ones((4, 1)), p])
    grads = np.linalg.inv(amat)[1:, :].T            # (4, 3): grad lambda_a
    return vol * (grads @ grads.T)


def p1_tet_mass(p0, p1, p2, p3) -> np.ndarray:
    """4x4 consistent P1 mass matrix = vol/20 * (1 + delta_ab)."""
    vol = tet_volume(p0, p1, p2, p3)
    return (vol / 20.0) * (np.ones((4, 4)) + np.eye(4))


def _keast11() -> Tuple[np.ndarray, np.ndarray]:
    """Keast 11-point rule on the tetrahedron, exact through degree 4;
    weights normalised to sum to 1."""
    pts, ws = [[0.25, 0.25, 0.25, 0.25]], [-0.078933333333333]
    a, b = 0.785714285714286, 0.071428571428571
    for i in range(4):
        q = [b] * 4
        q[i] = a
        pts.append(q)
        ws.append(0.045733333333333)
    c, d = 0.399403576166799, 0.100596423833201
    seen = set()
    for perm in itertools.permutations([c, c, d, d]):
        if perm in seen:
            continue
        seen.add(perm)
        pts.append(list(perm))
        ws.append(0.149333333333333)
    w = np.array(ws)
    return np.array(pts), w / w.sum()


_KEAST11_BARY, _KEAST11_W = _keast11()


def tet_quadrature() -> Tuple[np.ndarray, np.ndarray]:
    """(barycentric points (Q,4), weights (Q,) summing to 1)."""
    return _KEAST11_BARY, _KEAST11_W


def simplex_p1(ndim: int):
    """(stiffness fn, mass fn, measure fn, (barycentric points, weights))
    of the P1 simplex of dimension ndim."""
    if ndim == 2:
        return (p1_triangle_stiffness, p1_triangle_mass, triangle_area,
                triangle_quadrature())
    if ndim == 3:
        return p1_tet_stiffness, p1_tet_mass, tet_volume, tet_quadrature()
    raise ValueError(f"ndim must be 2 or 3, got {ndim}")
