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
    start;
  * 3D variable-coefficient diffusion (BASELINE.json config 4's P1 half):
    build_var_hierarchy builds stored coefficient planes on the device,
    with rediscretised or Galerkin (P^T A P) coarse operators, smoothed by
    multicolour Gauss-Seidel or weighted Jacobi on the planes;
  * 2D variable-coefficient diffusion (models.variable_coefficient_2d):
    the same build_var_hierarchy on the triangulated square (7 planes on
    the finest level, the 9-offset Galerkin box below), with the 2D
    planes kernels for the residual, Jacobi and multicolour GS;
  * 3D Poisson with P2 elements (BASELINE.json config 4's constant-
    coefficient P2 path, models.poisson3d_p2): build_p2_hierarchy builds
    every level as a plane-free parity-table operator on the half-step
    lattice, smoothed by snap weighted Jacobi, with the same FMG,
    tolerance loop and MG-CG;
  * the distributed 3D solve (parallel.halo3d): the constant-coefficient
    P1 path z-decomposed over the ranks of a torch.distributed process
    group, each holding a z-slab of the finer levels, with halo exchange,
    the coarse levels replicated, and the slab kernels K25-K29;
    parallel.run_ranks spawns the ranks;
  * the distributed 2D solve (parallel.halo): the constant-coefficient
    P1 path row-decomposed the same way (the JAX package's ('gx', 1)
    mesh), each rank holding a strip of rows of the finer levels, with
    the strip kernels K30-K34;
  * the single-device cycle's remaining options: W and F cycles, the
    reference's full-weighting restriction and the P1 prolongation, and
    CycleSpec.fusion, the JAX package's fused cycle steps (two red-black
    sweeps in one kernel, K35; the last pre-smoothing sweep with the
    residual and P^T, K36; the correction with the first post-smoothing
    sweep, K37), each bitwise the unfused cycle.
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
                               build_lean_hierarchy, build_p2_hierarchy,
                               build_var_hierarchy)
from .solver.fmg import (SolveResult, error_norm, fmg_solve, residual_norm,
                         resume_solve, solve)
from .solver.krylov import CGResult, mgcg_solve, solve_mgcg
from .solver.vcycle import vcycle
from .utils.convert import hierarchy_from_numpy
from .parallel import (build_halo_cycler, build_halo_cycler3d,
                       build_halo_mgcg3d, build_halo_resume3d,
                       build_halo_solver, build_halo_solver3d,
                       gather_solution, run_ranks)
from . import models, parallel

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
    "build_p2_hierarchy",
    "build_var_hierarchy",
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
    "build_halo_solver",
    "build_halo_cycler",
    "build_halo_solver3d",
    "build_halo_cycler3d",
    "build_halo_mgcg3d",
    "build_halo_resume3d",
    "gather_solution",
    "run_ranks",
    "models",
    "parallel",
    "__version__",
]
