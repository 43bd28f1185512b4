"""Hierarchy construction: per-level operators, b and g on the device.

Mirrors `multigrid_dolfinx_tpu.solver.hierarchy` for P1: for constant
coefficients in 2D and 3D, `build_lean_hierarchy` builds b and g on the
device from a tiny assembled prototype and `build_hierarchy` assembles
every level on the host (the reference's rediscretisation) and ships it;
for variable kappa in 2D and 3D, `build_var_hierarchy` builds every level's
coefficient planes, b and g on the device (fem.fast_var).  Frozen
dataclasses take the place of the JAX pytrees; every tensor lives on the
device given to the build function, the CUDA card unless the caller asks
for the CPU; for constant-coefficient P2 in 3D, `build_p2_hierarchy`
builds every level as a plane-free parity-table operator with b and g on
the device (fem.fast_p2).  Storage is the logical (n+1)^d box,
contiguous and unpadded, so there is no TPU tile padding, no cropped
layout and no precomputed full-layout reference norm.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from ..config import SolverConfig
from ..fem import assembly as fem_assembly
from ..fem.fast_const import (build_const_template, device_level_arrays,
                              mass_class_tables)
from ..fem import fast_p2, fast_var
from ..fem.norms import ErrorQuad, error_quadrature
from ..mesh import build_grid_hierarchy
from ..ops.coarse import CoarseSolver, build_coarse_solver
from ..ops.operators import StencilOperator, detect_const_stencil
from ..ops.smoothers import SmootherData

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class Level:
    """One device-resident grid level: operator A (const or planes),
    smoother data, lifted RHS b and Dirichlet values g (0 at interior
    nodes)."""

    A: StencilOperator
    sm: SmootherData
    b: torch.Tensor
    g: torch.Tensor
    n: int
    level: int


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """Levels coarsest (index 0) to finest (index -1), the factorised
    coarse solver, the finest-level mass operator (FEM-L2 residual norm)
    and the error-norm quadrature."""

    levels: Tuple[Level, ...]
    coarse: CoarseSolver
    M_fine: StencilOperator
    err_quad: ErrorQuad

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def finest(self) -> Level:
        return self.levels[-1]


def const_lmax_dirichlet(offsets, weights, n: int):
    """Exact largest eigenvalue of Dinv*A for an axis-only constant stencil
    with Dirichlet identity rows on the (n+1)^d box:
    1 + cos(pi/n) * sum_{k != center} |w_k| / wc.  None when the stencil
    has diagonal couplings."""
    offsets = tuple(map(tuple, offsets))
    center = offsets.index((0,) * len(offsets[0]))
    wc = float(weights[center])
    off_sum = 0.0
    for k, off in enumerate(offsets):
        if k == center or float(weights[k]) == 0.0:
            continue
        if sum(1 for d in off if d != 0) > 1:
            return None
        off_sum += abs(float(weights[k]))
    return 1.0 + math.cos(math.pi / n) * off_sum / wc


def resolve_device(device) -> torch.device:
    """The device to build on; CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def check_problem(config: SolverConfig, var: bool = False,
                  p2: bool = False) -> None:
    """Raise for problems outside the port's slices.  var=True checks for
    build_var_hierarchy (2D or 3D P1, variable kappa, constant RHS, either
    coarse operator, reaction allowed), p2=True for build_p2_hierarchy
    (3D P2, constant coefficient and RHS, rediscretised), else for the
    constant-coefficient P1 builds."""
    p, hs = config.problem, config.hierarchy
    if config.dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
    if p2:
        if p.degree != 2:
            raise ValueError("build_p2_hierarchy is the P2 path; P1 builds "
                             "with build_lean_hierarchy")
        if p.ndim != 3:
            raise NotImplementedError("2D P2 is ROADMAP.md queue 1, item 21")
        if (p.kappa is not None or p.reaction != 0.0
                or hs.coarse_operator != "rediscretize"):
            raise NotImplementedError(
                "P2 with variable kappa, a reaction term or Galerkin "
                "coarse operators goes through the host assembler, "
                "ROADMAP.md queue 1, item 20")
        if p.rhs_const is None:
            raise NotImplementedError(
                "the device P2 build needs a constant RHS (rhs_const); "
                "other right-hand sides go through the host assembler, "
                "ROADMAP.md queue 1, item 20")
        return
    if p.degree != 1:
        raise NotImplementedError(
            "P2 builds with build_p2_hierarchy (3D, ROADMAP.md queue 1, "
            "item 16); 2D P2 is ROADMAP.md queue 1, item 21")
    if var:
        if p.kappa is None:
            raise ValueError("build_var_hierarchy is the variable-"
                             "coefficient path; use build_lean_hierarchy "
                             "for kappa=None")
        if p.rhs_const is None:
            raise NotImplementedError(
                "build_var_hierarchy needs a constant RHS (rhs_const); "
                "other right-hand sides need the host-assembled variable-"
                "kappa build, ROADMAP.md queue 1, item 20")
        return
    if p.kappa is not None:
        raise NotImplementedError(
            "variable kappa builds with build_var_hierarchy (ROADMAP.md "
            "queue 1, item 14)")
    if hs.coarse_operator != "rediscretize":
        raise NotImplementedError(
            "Galerkin coarse operators build with build_var_hierarchy "
            "(variable kappa, ROADMAP.md queue 1, item 14); constant-"
            "coefficient Galerkin builds are ROADMAP.md queue 1, item 20")
    if p.reaction != 0.0:
        raise NotImplementedError(
            "reaction (screened Poisson) terms build with variable kappa "
            "through build_var_hierarchy (ROADMAP.md queue 1, item 14); "
            "screened problems without kappa are ROADMAP.md queue 1, "
            "item 20")


def mass_operator(offsets, class_tables: torch.Tensor, n: int,
                  diagonal: str) -> StencilOperator:
    """Finest-level consistent P1 mass in class-table form."""
    offsets = tuple(map(tuple, offsets))
    return StencilOperator(
        offsets=offsets, logical_m=n + 1,
        grid_shape=(n + 1,) * len(offsets[0]), class_tables=class_tables,
        uniform_p1_mass=diagonal,
    )


def const_level(offsets, weights, grid, b: torch.Tensor, g: torch.Tensor,
                config: SolverConfig, lmax: Optional[float] = None,
                dinv: Optional[torch.Tensor] = None) -> Level:
    """A level with a plane-free const operator of these weights; lmax
    defaults to the exact Dirichlet value (2.0 if the stencil has
    diagonal couplings), the Chebyshev degree is the config's."""
    if lmax is None:
        lmax = const_lmax_dirichlet(offsets, weights, grid.n)
    A = StencilOperator(
        offsets=tuple(map(tuple, offsets)), logical_m=grid.points_per_dim,
        grid_shape=grid.shape, const_weights=tuple(map(float, weights)))
    sm = SmootherData(lmax=2.0 if lmax is None else lmax,
                      omega=config.cycle.omega, dinv=dinv,
                      cheby_degree=config.cycle.cheby_degree)
    return Level(A=A, sm=sm, b=b, g=g, n=grid.n, level=grid.level)


def _finish(config: SolverConfig, levels, asm0, grids, dtype,
            device) -> Hierarchy:
    """Coarse factor, finest mass tables and error quadrature."""
    coarse = build_coarse_solver(asm0.offsets, asm0.A_planes,
                                 kind=config.cycle.coarse_solver,
                                 device=device)
    m_offsets, m_tables = mass_class_tables(config.problem)
    g_f = grids[-1]
    h_scale = (g_f.h * 4.0) ** g_f.ndim            # prototype h0 = 1/4
    M_fine = mass_operator(
        m_offsets,
        torch.as_tensor(m_tables * h_scale, dtype=dtype, device=device),
        g_f.n, config.problem.diagonal)
    return Hierarchy(
        levels=tuple(levels), coarse=coarse, M_fine=M_fine,
        err_quad=error_quadrature(g_f, config.problem),
    )


def build_lean_hierarchy(config: SolverConfig, device="cuda",
                         cut: Optional[Callable] = None) -> Hierarchy:
    """Scale-mode hierarchy for constant-coefficient P1 on `device` (the
    CUDA card by default; without one this raises).

    Levels carry plane-free const operators (weights as Python floats,
    interior masks from index arithmetic) and b, g built on the device
    from a tiny assembled prototype (fem.fast_const); the mass operator
    is a class table (9 x 9 in 2D, 15 x 27 in 3D) and the error norm is
    static metadata.  Only b and g cost device memory per level.
    cut(level index, array), where given, replaces each level's b and g
    as soon as they are built (the distributed build keeps a rank's
    z-slab of them)."""
    check_problem(config)
    device = resolve_device(device)
    dtype = DTYPES[config.dtype]
    ndim = config.problem.ndim
    grids = build_grid_hierarchy(config.hierarchy, ndim=ndim)
    template = build_const_template(config.problem)
    h0 = 1.0 / template.proto_n

    levels = []
    for li, g in enumerate(grids):
        b, gdir = device_level_arrays(template, g, config.problem, dtype,
                                      device)
        if cut is not None:
            b, gdir = cut(li, b), cut(li, gdir)
        scale = (g.h / h0) ** (ndim - 2)   # stiffness scales as h^(d-2)
        w_level = tuple(w * scale for w in template.weights)
        levels.append(const_level(template.offsets, w_level, g, b, gdir,
                                  config))
    asm0 = fem_assembly.assemble_level(grids[0], config.problem)
    return _finish(config, levels, asm0, grids, dtype, device)


def build_hierarchy(config: SolverConfig, device="cuda") -> Hierarchy:
    """Assembled hierarchy: every level assembled on the host with
    dolfinx's Dirichlet semantics (the reference's per-level
    rediscretisation) and shipped to `device` (the CUDA card by default),
    with b, g and the Jacobi dinv = 1/diag A stored per level.  The
    operators are detected as constant stencils and run plane-free, as the
    JAX package does; the reference's exact run, models.poisson2d(),
    builds this way."""
    check_problem(config)
    if config.cycle.smoother == "chebyshev":
        # the JAX assembled build estimates lmax by power iteration; the
        # exact Dirichlet lmax stored here would give another window
        raise NotImplementedError(
            "smoother 'chebyshev' on the assembled build needs the "
            "power-iteration lmax (hierarchy.py estimate_lmax_dinv_a), "
            "ROADMAP.md queue 1, item 19")
    device = resolve_device(device)
    dtype = DTYPES[config.dtype]
    grids = build_grid_hierarchy(config.hierarchy, ndim=config.problem.ndim)
    asms = fem_assembly.assemble_hierarchy(grids, config.problem)

    def tensor(a):
        return torch.tensor(a, dtype=dtype, device=device)

    levels = []
    for g, asm in zip(grids, asms):
        w = detect_const_stencil(asm.offsets, asm.A_planes, asm.interior)
        if w is None:
            raise NotImplementedError(
                "assembled levels that are not constant stencils need the "
                "host-assembled planes build, ROADMAP.md queue 1, item 20")
        center = asm.offsets.index((0,) * g.ndim)
        levels.append(const_level(asm.offsets, w, g, tensor(asm.b),
                                  tensor(asm.g), config,
                                  dinv=tensor(1.0 / asm.A_planes[center])))
    return _finish(config, levels, asms[0], grids, dtype, device)


def planes_level(offsets, planes: torch.Tensor, grid, b: torch.Tensor,
                 g: torch.Tensor, config: SolverConfig) -> Level:
    """A level with a stored-planes operator (Dirichlet-eliminated); 1/diag
    is not stored (the kernels and A.dinv() take it from the centre
    plane); lmax is the JAX var build's 2.0 (only Chebyshev reads it, and
    the var build raises for Chebyshev)."""
    A = StencilOperator(offsets=tuple(map(tuple, offsets)),
                        logical_m=grid.points_per_dim, grid_shape=grid.shape,
                        planes=planes)
    sm = SmootherData(lmax=2.0, omega=config.cycle.omega,
                      cheby_degree=config.cycle.cheby_degree)
    return Level(A=A, sm=sm, b=b, g=g, n=grid.n, level=grid.level)


def check_var_cycle(config: SolverConfig) -> None:
    """The var build's smoothers are K16 and K17; Chebyshev needs the
    power-iteration lmax."""
    if config.cycle.smoother == "chebyshev":
        raise NotImplementedError(
            "smoother 'chebyshev' on the variable-kappa build needs the "
            "power-iteration lmax (fast_var.py device_lmax_dinv_a), "
            "ROADMAP.md queue 1, item 19")


def build_var_hierarchy(config: SolverConfig, device="cuda") -> Hierarchy:
    """Hierarchy for variable-coefficient 2D or 3D P1 on `device` (the
    CUDA card by default; without one this raises), built there level by
    level, finest first (fem.fast_var): kappa fields from index
    coordinates, raw planes as shifted multiply-adds, b and g with lifting
    by the level's rediscretised raw planes (also in Galerkin mode, as
    build_hierarchy's per-level assembly), then the operator: the level's
    own planes (rediscretize; the 15 Kuhn offsets in 3D, 7 in 2D) or
    P^T A P of the finer level's eliminated planes (galerkin below the
    finest; the 3^d box), Dirichlet eliminated in place.  The coarse
    factor comes from the coarsest eliminated planes in f64; the mass
    operator is the class table of the constant-coefficient P1 mass.
    Stores K planes, b and g per level; no 1/diag and no R_omega planes
    (the Jacobi and GS kernels form D^-1 (A - D) from A itself)."""
    check_problem(config, var=True)
    check_var_cycle(config)
    device = resolve_device(device)
    dtype = DTYPES[config.dtype]
    problem = config.problem
    grids = build_grid_hierarchy(config.hierarchy, ndim=problem.ndim)
    template = fast_var.build_var_template(problem)
    galerkin = config.hierarchy.coarse_operator == "galerkin"

    levels = []
    prev = None               # (offsets, eliminated planes) of the finer level
    for idx in range(len(grids) - 1, -1, -1):
        g = grids[idx]
        lm = g.points_per_dim
        raw = fast_var.device_raw_planes(template, g, problem.kappa, dtype,
                                         device)
        b, gdir = fast_var.device_level_b_g(template, g, problem, raw, dtype)
        if galerkin and prev is not None:
            del raw
            offs, planes = fast_var.galerkin_rap_device(
                prev[0], prev[1], grids[idx + 1].points_per_dim)
        else:
            offs, planes = template.offsets, raw
        planes = fast_var.eliminate_dirichlet_device(offs, planes, lm)
        levels.append(planes_level(offs, planes, g, b, gdir, config))
        prev = (offs, planes)
    levels.reverse()                        # coarsest .. finest

    coarse = build_coarse_solver(
        levels[0].A.offsets, levels[0].A.planes.cpu().double().numpy(),
        kind=config.cycle.coarse_solver, device=device)
    const_prob = dataclasses.replace(problem, kappa=None, reaction=0.0)
    m_offsets, m_tables = mass_class_tables(const_prob)
    g_f = grids[-1]
    M_fine = mass_operator(
        m_offsets,
        torch.as_tensor(m_tables * (g_f.h * 4.0) ** g_f.ndim, dtype=dtype,
                        device=device),
        g_f.n, problem.diagonal)
    return Hierarchy(levels=tuple(levels), coarse=coarse, M_fine=M_fine,
                     err_quad=error_quadrature(g_f, problem))


def check_p2_cycle(config: SolverConfig) -> None:
    """The P2 smoother is snap-Jacobi (K20): Chebyshev needs the
    power-iteration lmax, multicolour GS a kernel of its own."""
    smoother = config.cycle.smoother
    if smoother == "chebyshev":
        raise NotImplementedError(
            "smoother 'chebyshev' on P2 needs the power-iteration lmax "
            "(fast_p2.py device_p2_lmax), ROADMAP.md queue 1, item 19")
    if smoother == "rbgs":
        raise NotImplementedError(
            "smoother 'rbgs' on P2 (27-colour mod-3 Gauss-Seidel) is "
            "ROADMAP.md queue 1, item 22")


def p2_level(offsets, grid, b: torch.Tensor, g: torch.Tensor,
             config: SolverConfig, tables: torch.Tensor) -> Level:
    """A P2 level of the element grid `grid`: the parity stiffness of
    these tables on the (2n+1)^3 lattice (Level.n = 2n lattice
    intervals); lmax is the JAX build's 2.0 (only Chebyshev reads it)."""
    lm = 2 * grid.n + 1
    A = StencilOperator(offsets=tuple(map(tuple, offsets)), logical_m=lm,
                        grid_shape=(lm,) * grid.ndim, parity_tables=tables)
    sm = SmootherData(lmax=2.0, omega=config.cycle.omega,
                      cheby_degree=config.cycle.cheby_degree)
    return Level(A=A, sm=sm, b=b, g=g, n=2 * grid.n, level=grid.level)


def p2_mass_operator(offsets, grid, tables: torch.Tensor) -> StencilOperator:
    """The finest level's raw consistent P2 mass in parity-table form."""
    lm = 2 * grid.n + 1
    return StencilOperator(offsets=tuple(map(tuple, offsets)), logical_m=lm,
                           grid_shape=(lm,) * grid.ndim,
                           parity_tables=tables, boundary_mode="raw")


def build_p2_hierarchy(config: SolverConfig, device="cuda") -> Hierarchy:
    """Hierarchy for constant-coefficient 3D P2 on `device` (the CUDA card
    by default; without one this raises).  Every level is a plane-free
    parity-table operator (fem.fast_p2): the (51, 64) stiffness table of
    the n0 = 4 prototype scaled by h in f64 and cast to the dtype, with b
    and g built on the device; coarse levels are rediscretised.  The
    coarsest level's assembled P2 matrix is factorised on the host (f64);
    the mass operator is the raw (65, 64) parity table of the finest
    level, so the per-cycle check K19 + K21 is exact on face rows too
    and no zero-iterate norm is precomputed.  Stores b and g per level
    and nothing else of grid size."""
    check_problem(config, p2=True)
    check_p2_cycle(config)
    device = resolve_device(device)
    dtype = DTYPES[config.dtype]
    problem = config.problem
    ndim = problem.ndim
    grids = build_grid_hierarchy(config.hierarchy, ndim=ndim)
    template = fast_p2.build_p2_template(problem)
    levels = []
    for g in grids:
        b, gdir = fast_p2.device_p2_level_arrays(template, g.n, problem,
                                                 dtype, device)
        tables = fast_p2.level_tables(template.a_unit, g.h ** (ndim - 2),
                                      dtype, device)
        levels.append(p2_level(template.offsets, g, b, gdir, config,
                               tables))
    asm0 = fem_assembly.assemble_level(grids[0], problem)
    coarse = build_coarse_solver(asm0.offsets, asm0.A_planes,
                                 kind=config.cycle.coarse_solver,
                                 device=device)
    g_f = grids[-1]
    M_fine = p2_mass_operator(
        template.m_offsets, g_f,
        fast_p2.level_tables(template.m_unit, g_f.h ** ndim, dtype, device))
    return Hierarchy(levels=tuple(levels), coarse=coarse, M_fine=M_fine,
                     err_quad=error_quadrature(g_f, problem))
