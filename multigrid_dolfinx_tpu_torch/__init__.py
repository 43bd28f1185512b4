"""multigrid_dolfinx_tpu_torch — the PyTorch / CUDA port of
multigrid_dolfinx_tpu.

Its slices so far:
  * the main path: 3D Poisson with P1 elements on Kuhn tetrahedra (the
    constant 7-point stencil), the lean hierarchy built on the device, an
    FMG start and V(ν1, ν2) cycles with red-black Gauss-Seidel,
    variational P^T restriction and trilinear prolongation, a dense
    coarsest solve factorised once, and a fused FEM-L2 residual check
    after each cycle;
  * 2D P1 Poisson (the constant 5-point stencil): the reference's exact
    run (models.poisson2d() through the assembled build_hierarchy: FMG +
    V(50,50) weighted Jacobi with injection, 63 cycles to 1e-11) and the
    lean V(2,2) red-black / P^T solve at full width;
  * BASELINE.json configurations 3 and 5: Chebyshev smoothing (one
    degree-ν polynomial per phase, the fused momentum-form step in 3D),
    3D weighted Jacobi and 3D injection in the V-cycle, and flexible
    MG-preconditioned CG (solve_mgcg / mgcg_solve) from an FMG or a zero
    start.
On a CUDA device the hot ops run as hand-written Hopper kernels
(ops/cuda, sources in csrc/); on the CPU they run as the kernels' plain
PyTorch versions.  This package never imports JAX.

Quick start::

    from multigrid_dolfinx_tpu_torch import (models, build_lean_hierarchy,
                                             solve, solve_mgcg)
    from multigrid_dolfinx_tpu_torch.config import CycleSpec
    cyc = CycleSpec(nu1=2, nu2=2, smoother="rbgs", restriction="pt",
                    tol=0.0, rtol=1e-8, max_cycles=40, track_error=False)
    cfg = models.poisson3d(finest_level=6, coarsest_level=0,
                           coarsest_elements=8, dtype="float32", cycle=cyc)
    hier = build_lean_hierarchy(cfg)    # on the CUDA card by default
    res = solve(hier, cyc)      # res.num_cycles, res.res_hist, res.u
    cg = solve_mgcg(hier, cyc)  # cg.num_iters, cg.res_hist, cg.u
"""

from .config import CycleSpec, HierarchySpec, ProblemSpec, SolverConfig
from .mesh import GridLevel, build_grid_hierarchy
from .solver.hierarchy import (Hierarchy, Level, build_hierarchy,
                               build_lean_hierarchy)
from .solver.fmg import (SolveResult, error_norm, fmg_solve, residual_norm,
                         resume_solve, solve)
from .solver.krylov import CGResult, mgcg_solve, solve_mgcg
from .solver.vcycle import vcycle
from .utils.convert import hierarchy_from_numpy
from . import models

__version__ = "0.1.0"

__all__ = [
    "CycleSpec",
    "HierarchySpec",
    "ProblemSpec",
    "SolverConfig",
    "GridLevel",
    "build_grid_hierarchy",
    "Hierarchy",
    "Level",
    "build_hierarchy",
    "build_lean_hierarchy",
    "SolveResult",
    "fmg_solve",
    "solve",
    "resume_solve",
    "residual_norm",
    "error_norm",
    "vcycle",
    "CGResult",
    "mgcg_solve",
    "solve_mgcg",
    "hierarchy_from_numpy",
    "models",
    "__version__",
]
