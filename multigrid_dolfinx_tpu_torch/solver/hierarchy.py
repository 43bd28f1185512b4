"""Hierarchy construction: per-level operators, b and g on the device.

Mirrors `multigrid_dolfinx_tpu.solver.hierarchy` for the P1 const path in
2D and 3D: `build_lean_hierarchy` builds b and g on the device from a
tiny assembled prototype, `build_hierarchy` assembles every level on the
host (the reference's rediscretisation) and ships it.  Frozen
dataclasses take the place of the JAX pytrees; every tensor lives on the
device given to the build function, the CUDA card unless the caller asks
for the CPU.  Storage is the logical (n+1)^d box,
contiguous and unpadded, so there is no TPU tile padding, no cropped
layout and no precomputed full-layout reference norm.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..config import SolverConfig
from ..fem import assembly as fem_assembly
from ..fem.fast_const import (build_const_template, device_level_arrays,
                              mass_class_tables)
from ..fem.norms import ErrorQuad, error_quadrature
from ..mesh import build_grid_hierarchy
from ..ops.coarse import CoarseSolver, build_coarse_solver
from ..ops.operators import StencilOperator, detect_const_stencil
from ..ops.smoothers import SmootherData

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class Level:
    """One device-resident grid level: const operator A, smoother data,
    lifted RHS b and Dirichlet values g (0 at interior nodes)."""

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


def check_problem(config: SolverConfig) -> None:
    """Raise NotImplementedError for problems outside the port's slice."""
    p, hs = config.problem, config.hierarchy
    if p.degree != 1:
        raise NotImplementedError("P2 is ROADMAP.md queue 1, item 16")
    if p.kappa is not None or hs.coarse_operator != "rediscretize":
        raise NotImplementedError(
            "variable kappa and Galerkin coarse operators are ROADMAP.md "
            "queue 1, item 14")
    if p.reaction != 0.0:
        raise NotImplementedError(
            "reaction (screened Poisson) terms are ROADMAP.md queue 1, "
            "item 14")
    if config.dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}")


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


def build_lean_hierarchy(config: SolverConfig,
                         device="cuda") -> Hierarchy:
    """Scale-mode hierarchy for constant-coefficient P1 on `device` (the
    CUDA card by default; without one this raises).

    Levels carry plane-free const operators (weights as Python floats,
    interior masks from index arithmetic) and b, g built on the device
    from a tiny assembled prototype (fem.fast_const); the mass operator
    is a class table (9 x 9 in 2D, 15 x 27 in 3D) and the error norm is
    static metadata.  Only b and g cost device memory per level."""
    check_problem(config)
    device = resolve_device(device)
    dtype = DTYPES[config.dtype]
    ndim = config.problem.ndim
    grids = build_grid_hierarchy(config.hierarchy, ndim=ndim)
    template = build_const_template(config.problem)
    h0 = 1.0 / template.proto_n

    levels = []
    for g in grids:
        b, gdir = device_level_arrays(template, g, config.problem, dtype,
                                      device)
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
                "stored-planes operators are ROADMAP.md queue 1, item 14")
        center = asm.offsets.index((0,) * g.ndim)
        levels.append(const_level(asm.offsets, w, g, tensor(asm.b),
                                  tensor(asm.g), config,
                                  dinv=tensor(1.0 / asm.A_planes[center])))
    return _finish(config, levels, asms[0], grids, dtype, device)
