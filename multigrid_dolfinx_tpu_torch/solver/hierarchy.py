"""Lean hierarchy construction: per-level b and g built on the device.

Mirrors `multigrid_dolfinx_tpu.solver.hierarchy` for the 3D P1 const
path.  Frozen dataclasses take the place of the JAX pytrees; every tensor
lives on the device given to `build_lean_hierarchy`.  Storage is the
logical (n+1)^3 box, contiguous and unpadded, so there is no TPU tile
padding, no cropped layout and no precomputed full-layout reference norm.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..config import SolverConfig
from ..fem import assembly as fem_assembly
from ..fem.fast_const import (build_const_template, device_level_arrays,
                              mass_class_tables)
from ..fem.norms import ErrorQuad, error_quadrature
from ..mesh import build_grid_hierarchy
from ..ops.coarse import CoarseSolver, build_coarse_solver
from ..ops.operators import StencilOperator
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
    if p.ndim != 3:
        raise NotImplementedError("2D is ROADMAP.md queue 1, item 11")
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
    return StencilOperator(
        offsets=tuple(map(tuple, offsets)), logical_m=n + 1,
        grid_shape=(n + 1,) * 3, class_tables=class_tables,
        uniform_p1_mass=diagonal,
    )


def build_lean_hierarchy(config: SolverConfig, device) -> Hierarchy:
    """Scale-mode hierarchy for constant-coefficient 3D P1 on `device`.

    Levels carry plane-free const operators (weights as Python floats,
    interior masks from index arithmetic) and b, g built on the device
    from a tiny assembled prototype (fem.fast_const); the mass operator
    is a 15 x 27 class table and the error norm is static metadata.  Only
    b and g cost device memory per level."""
    check_problem(config)
    device = resolve_device(device)
    dtype = DTYPES[config.dtype]
    grids = build_grid_hierarchy(config.hierarchy, ndim=3)
    template = build_const_template(config.problem)
    h0 = 1.0 / template.proto_n

    levels = []
    for g in grids:
        b, gdir = device_level_arrays(template, g, config.problem, dtype,
                                      device)
        scale = g.h / h0          # stiffness scales as h^(d-2) = h in 3D
        w_level = tuple(w * scale for w in template.weights)
        lmax = const_lmax_dirichlet(template.offsets, w_level, g.n)
        A = StencilOperator(
            offsets=template.offsets, logical_m=g.points_per_dim,
            grid_shape=g.shape, const_weights=w_level)
        sm = SmootherData(lmax=2.0 if lmax is None else lmax,
                          omega=config.cycle.omega)
        levels.append(Level(A=A, sm=sm, b=b, g=gdir, n=g.n, level=g.level))

    asm0 = fem_assembly.assemble_level(grids[0], config.problem)
    coarse = build_coarse_solver(asm0.offsets, asm0.A_planes,
                                 kind=config.cycle.coarse_solver,
                                 device=device)
    m_offsets, m_tables = mass_class_tables(config.problem)
    g_f = grids[-1]
    h_scale = (g_f.h * 4.0) ** 3                   # prototype h0 = 1/4
    M_fine = mass_operator(
        m_offsets,
        torch.as_tensor(m_tables * h_scale, dtype=dtype, device=device),
        g_f.n, config.problem.diagonal)
    return Hierarchy(
        levels=tuple(levels), coarse=coarse, M_fine=M_fine,
        err_quad=error_quadrature(g_f, config.problem),
    )
