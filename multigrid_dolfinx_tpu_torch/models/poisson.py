"""Problem families of the port: 2D Poisson (the reference's problem) and
3D Poisson (the main path).

The other constructors of `multigrid_dolfinx_tpu.models` (P2, variable
coefficient, screened) belong to later slices of the port (ROADMAP.md
queue 1, items 14 and 16).
"""
from __future__ import annotations

from typing import Optional

from ..config import CycleSpec, HierarchySpec, ProblemSpec, SolverConfig


def poisson2d(
    finest_level: int = 3,
    coarsest_level: int = 1,
    coarsest_elements: int = 8,
    dtype: str = "float64",
    cycle: Optional[CycleSpec] = None,
    diagonal: str = "right",
) -> SolverConfig:
    """The reference problem: -Laplace(u) = -6 on the unit square,
    u* = 1 + x^2 + 2y^2; by default its exact run (65^2, 3 levels, FMG +
    V(50,50) weighted Jacobi, injection, tol 1e-11, f64)."""
    return SolverConfig(
        problem=ProblemSpec(ndim=2, rhs_const=-6.0, diagonal=diagonal),
        hierarchy=HierarchySpec(
            coarsest_elements=coarsest_elements,
            coarsest_level=coarsest_level,
            finest_level=finest_level,
        ),
        cycle=cycle if cycle is not None else CycleSpec(),
        dtype=dtype,
    )


def poisson3d(
    finest_level: int = 2,
    coarsest_level: int = 0,
    coarsest_elements: int = 8,
    dtype: str = "float32",
    cycle: Optional[CycleSpec] = None,
) -> SolverConfig:
    """3D Poisson on the unit cube: u* = 1 + x^2 + 2y^2 + 3z^2, f = -12."""
    return SolverConfig(
        problem=ProblemSpec(ndim=3, rhs_const=-12.0),
        hierarchy=HierarchySpec(
            coarsest_elements=coarsest_elements,
            coarsest_level=coarsest_level,
            finest_level=finest_level,
        ),
        cycle=cycle if cycle is not None else CycleSpec(nu1=2, nu2=2),
        dtype=dtype,
    )
