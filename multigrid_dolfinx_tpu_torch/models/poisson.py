"""Problem families of the port: 2D Poisson (the reference's problem), 3D
Poisson (the main path), 2D and 3D variable-coefficient diffusion with
Galerkin coarse operators and 3D Poisson with P2 elements.

The other constructors of `multigrid_dolfinx_tpu.models` (2D P2,
screened) belong to later slices of the port (ROADMAP.md queue 1, items
20 and 21).
"""
from __future__ import annotations

from typing import Callable, Optional

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


def variable_coefficient_2d(
    kappa: Callable,
    finest_level: int = 3,
    coarsest_level: int = 1,
    coarsest_elements: int = 8,
    dtype: str = "float64",
    cycle: Optional[CycleSpec] = None,
    exact: Optional[Callable] = None,
    rhs: Optional[Callable] = None,
) -> SolverConfig:
    """2D -div(kappa grad u) = f, kappa evaluated per triangle at its
    centroid, with Galerkin (RAP) coarse operators (BASELINE.json config
    4); the JAX package's defaults (V(2,2) Jacobi, injection).  kappa,
    exact and rhs are callables of torch tensors (plain arithmetic works);
    build with build_var_hierarchy."""
    return SolverConfig(
        problem=ProblemSpec(
            ndim=2, kappa=kappa, exact=exact, rhs=rhs,
            rhs_const=None if rhs is not None else -6.0,
        ),
        hierarchy=HierarchySpec(
            coarsest_elements=coarsest_elements,
            coarsest_level=coarsest_level,
            finest_level=finest_level,
            coarse_operator="galerkin",
        ),
        cycle=cycle if cycle is not None else CycleSpec(nu1=2, nu2=2),
        dtype=dtype,
    )


def variable_coefficient_3d(
    kappa: Callable,
    finest_level: int = 2,
    coarsest_level: int = 0,
    coarsest_elements: int = 8,
    dtype: str = "float64",
    cycle: Optional[CycleSpec] = None,
    exact: Optional[Callable] = None,
    rhs: Optional[Callable] = None,
) -> SolverConfig:
    """3D -div(kappa grad u) = f, kappa evaluated per simplex at its
    centroid, with Galerkin (RAP) coarse operators (BASELINE.json config
    4).  kappa, exact and rhs are callables of torch tensors (plain
    arithmetic works); build with build_var_hierarchy."""
    return SolverConfig(
        problem=ProblemSpec(
            ndim=3, kappa=kappa, exact=exact, rhs=rhs,
            rhs_const=None if rhs is not None else -12.0,
        ),
        hierarchy=HierarchySpec(
            coarsest_elements=coarsest_elements,
            coarsest_level=coarsest_level,
            finest_level=finest_level,
            coarse_operator="galerkin",
        ),
        cycle=cycle if cycle is not None else CycleSpec(nu1=2, nu2=2),
        dtype=dtype,
    )


def poisson3d_p2(
    finest_level: int = 1,
    coarsest_level: int = 0,
    coarsest_elements: int = 4,
    dtype: str = "float32",
    cycle: Optional[CycleSpec] = None,
    coarse_operator: str = "rediscretize",
) -> SolverConfig:
    """3D Poisson with P2 elements on the Kuhn-tetrahedra cube (BASELINE.json
    config 4's 3D form): u* = 1 + x^2 + 2y^2 + 3z^2 lies in the P2 space,
    f = -12.  DOFs live on the half-step lattice ((2n+1)^3 points at n^3
    elements); build with build_p2_hierarchy, whose levels are all
    rediscretised plane-free parity-table operators."""
    return SolverConfig(
        problem=ProblemSpec(ndim=3, degree=2, rhs_const=-12.0),
        hierarchy=HierarchySpec(
            coarsest_elements=coarsest_elements,
            coarsest_level=coarsest_level,
            finest_level=finest_level,
            coarse_operator=coarse_operator,
        ),
        cycle=cycle if cycle is not None else CycleSpec(
            nu1=2, nu2=2, smoother="jacobi", restriction="pt",
        ),
        dtype=dtype,
    )
