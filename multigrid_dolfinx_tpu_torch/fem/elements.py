"""P1 tetrahedron element matrices and quadrature (numpy, setup path only).

The P1 subset of `multigrid_dolfinx_tpu.fem.elements` that the 3D
assembly and norms use; the triangle and P2 pieces come with the 2D and
P2 slices (ROADMAP.md queue 1, items 11 and 16).
"""
from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np


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
