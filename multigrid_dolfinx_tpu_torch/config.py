"""Configuration dataclasses of the PyTorch port.

Mirrors `multigrid_dolfinx_tpu.config` field for field, minus what only the
TPU build needed — the sharding spec, the `use_pallas` switch (the port
picks its CUDA kernels by the device a tensor lives on, never by a flag)
and the jnp kappa presets — and minus `check_every`, which no code reads.
It adds one field, `CycleSpec.fusion`, which takes the place of the JAX
package's MG_RB2 / MG_CYCLE_FUSE / MG_FUSE_A / MG_FUSE_B environment
switches.  Values the port does not run on a path yet are still accepted
here, so configs stay interchangeable with the JAX package; that path
raises NotImplementedError on them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple


def _default_exact_3d(x, y, z):
    """u = 1 + x^2 + 2 y^2 + 3 z^2, -Laplacian = -12.  Plain arithmetic, so
    it evaluates on numpy arrays and torch tensors alike."""
    return 1.0 + x * x + 2.0 * y * y + 3.0 * z * z


def _default_exact_2d(x, y):
    """Manufactured solution of the reference: u = 1 + x^2 + 2 y^2."""
    return 1.0 + x * x + 2.0 * y * y


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """-div(kappa grad u) = f on the unit square/cube, Dirichlet BC from
    the manufactured solution on the whole boundary."""

    ndim: int = 2
    degree: int = 1
    rhs_const: Optional[float] = -6.0
    rhs: Optional[Callable] = None
    exact: Optional[Callable] = None
    kappa: Optional[Callable] = None
    reaction: float = 0.0
    diagonal: str = "right"

    def resolved_exact(self) -> Callable:
        if self.exact is not None:
            return self.exact
        return _default_exact_2d if self.ndim == 2 else _default_exact_3d

    def resolved_rhs(self) -> Callable:
        if self.rhs is not None:
            return self.rhs
        c = self.rhs_const
        if c is None:
            raise ValueError("either rhs_const or rhs must be set")
        if self.ndim == 2:
            return lambda x, y: c + 0.0 * x
        return lambda x, y, z: c + 0.0 * x

    def __post_init__(self):
        if self.ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {self.ndim}")
        if self.degree not in (1, 2):
            raise ValueError(f"degree must be 1 or 2, got {self.degree}")
        if self.diagonal not in ("right", "left"):
            raise ValueError(
                f"diagonal must be 'right' or 'left', got {self.diagonal}")


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """Levels run from `coarsest_level` to `finest_level`; level i has
    `coarsest_elements * 2**i` elements per dimension."""

    coarsest_elements: int = 8
    coarsest_level: int = 1
    finest_level: int = 3
    coarse_operator: str = "rediscretize"

    @property
    def num_levels(self) -> int:
        return self.finest_level - self.coarsest_level + 1

    def elements_at(self, level: int) -> int:
        return self.coarsest_elements * (2 ** level)

    def levels(self) -> Sequence[int]:
        return tuple(range(self.coarsest_level, self.finest_level + 1))

    def __post_init__(self):
        if self.finest_level < self.coarsest_level:
            raise ValueError("finest_level must be >= coarsest_level")
        if self.coarsest_elements < 2:
            raise ValueError("coarsest_elements must be >= 2")
        if self.coarse_operator not in ("rediscretize", "galerkin"):
            raise ValueError(f"bad coarse_operator {self.coarse_operator}")


#: Members of CycleSpec.fusion and the JAX package's switches they stand
#: for: "rb2" MG_RB2=1 (sweep pairs as one kernel, K35), "rb_restrict"
#: MG_CYCLE_FUSE=1 with MG_FUSE_A (the last pre-smoothing sweep, the
#: residual and P^T as one kernel, K36), "prolong_rb" MG_CYCLE_FUSE=1 with
#: MG_FUSE_B (the correction and the first post-smoothing sweep as one
#: kernel, K37).
FUSIONS = ("rb2", "rb_restrict", "prolong_rb")


@dataclasses.dataclass(frozen=True)
class CycleSpec:
    """Multigrid-cycle parameters (defaults are the reference's: V(50,50)
    weighted Jacobi, injection, tol 1e-11 on the FEM-L2 residual norm).
    `fusion` names the fused kernels a 3D const-7 red-black level runs
    (FUSIONS); each gives the unfused result bitwise, and () (the JAX
    package's default) runs none."""

    mu0: int = 2
    nu1: int = 50
    nu2: int = 50
    omega: float = 2.0 / 3.0
    smoother: str = "jacobi"
    cheby_degree: int = 0
    cycle: str = "V"
    restriction: str = "injection"
    prolongation: str = "bilinear"
    coarse_solver: str = "cholesky"
    tol: float = 1e-11
    rtol: float = 0.0
    max_cycles: int = 100
    track_error: bool = True
    fusion: Tuple[str, ...] = ()

    def __post_init__(self):
        if not isinstance(self.fusion, tuple):
            raise TypeError(f"fusion must be a tuple, got {self.fusion!r}")
        bad = [m for m in self.fusion if m not in FUSIONS]
        if bad or len(set(self.fusion)) != len(self.fusion):
            raise ValueError(f"bad fusion {self.fusion!r}: members are "
                             f"distinct names from {FUSIONS}")
        if self.smoother not in ("jacobi", "rbgs", "chebyshev"):
            raise ValueError(f"bad smoother {self.smoother}")
        if self.cycle not in ("V", "W", "F"):
            raise ValueError(f"bad cycle {self.cycle}")
        if self.restriction not in ("injection", "full_weighting", "pt"):
            raise ValueError(f"bad restriction {self.restriction}")
        if self.prolongation not in ("bilinear", "p1"):
            raise ValueError(f"bad prolongation {self.prolongation}")
        if self.coarse_solver not in ("cholesky", "inverse", "lu"):
            raise ValueError(f"bad coarse_solver {self.coarse_solver}")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Top-level bundle: everything needed to build and run a solve."""

    problem: ProblemSpec = dataclasses.field(default_factory=ProblemSpec)
    hierarchy: HierarchySpec = dataclasses.field(default_factory=HierarchySpec)
    cycle: CycleSpec = dataclasses.field(default_factory=CycleSpec)
    dtype: str = "float64"
