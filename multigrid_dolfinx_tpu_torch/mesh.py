"""Implicit structured mesh hierarchy (numpy; mirrors
`multigrid_dolfinx_tpu.mesh`).

A level is a tensor-product grid: node (i, j, k) sits at (i h, j h, k h)
and unknowns live in a dense (n+1)^d array, so neighbour and parity
relations are index arithmetic and the boundary is an index mask.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .config import HierarchySpec


@dataclasses.dataclass(frozen=True)
class GridLevel:
    """One level: `n` elements per dimension, h = 1/n, n+1 nodes per axis."""

    level: int
    ndim: int
    n: int

    @property
    def h(self) -> float:
        return 1.0 / self.n

    @property
    def points_per_dim(self) -> int:
        return self.n + 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.n + 1,) * self.ndim

    def coords(self) -> Tuple[np.ndarray, ...]:
        """Nodal coordinate arrays, each of shape `self.shape`."""
        axes = [np.linspace(0.0, 1.0, self.n + 1) for _ in range(self.ndim)]
        return tuple(np.meshgrid(*axes, indexing="ij"))

    def boundary_mask(self) -> np.ndarray:
        mask = np.zeros(self.shape, dtype=bool)
        for axis in range(self.ndim):
            idx_lo = [slice(None)] * self.ndim
            idx_hi = [slice(None)] * self.ndim
            idx_lo[axis] = 0
            idx_hi[axis] = -1
            mask[tuple(idx_lo)] = True
            mask[tuple(idx_hi)] = True
        return mask

    def interior_mask(self) -> np.ndarray:
        return ~self.boundary_mask()


def factor_levels(n_elems: int, min_coarsest: int = 8) -> tuple:
    """Factor a finest-grid size into `(coarsest_elements, finest_level)`
    with `coarsest_elements * 2**finest_level == n_elems`."""
    level, base = 0, int(n_elems)
    while base % 2 == 0 and base > min_coarsest:
        base //= 2
        level += 1
    return base, level


def build_grid_hierarchy(spec: HierarchySpec, ndim: int = 2) -> List[GridLevel]:
    """Levels ordered coarsest -> finest."""
    return [
        GridLevel(level=lvl, ndim=ndim, n=spec.elements_at(lvl))
        for lvl in spec.levels()
    ]
