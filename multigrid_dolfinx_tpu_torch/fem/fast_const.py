"""O(1)-host-memory level construction for constant-coefficient P1.

Every level of constant-coefficient P1 Poisson is determined by
translation-invariant data taken once from a small assembled prototype
grid (n = 4): the eliminated interior stencil weights, the raw weights
used for lifting, and a per-boundary-class table of the raw load vector.
The fine arrays are then built on the target device with torch ops:

    b_raw[p] = f * h^d * T[class(p)]
    b       = where(bc, g, b_raw - A_raw g),   g = u*(x_p) on bc

so a 512^3 level needs no host-side O(N) array.  Mirrors
`multigrid_dolfinx_tpu.fem.fast_const`, with `device_level_arrays`
rewritten as torch ops on an explicit device and without the TPU tile
padding (storage is the logical (n+1)^d box).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import ProblemSpec
from ..mesh import GridLevel
from ..ops.operators import axis_range_mask, box_interior_mask, class_index
from ..ops.operators import detect_const_stencil
from . import assembly as fa
from . import elements


@dataclasses.dataclass(frozen=True)
class ConstTemplate:
    """Translation-invariant level data of the prototype spacing
    h0 = 1/proto_n; stiffness entries scale with h^(d-2)."""

    proto_n: int
    offsets: Tuple[Tuple[int, ...], ...]
    weights: Tuple[float, ...]        # eliminated interior weights (at h0)
    raw_weights: Tuple[float, ...]    # pre-elimination weights (at h0)
    load_table: np.ndarray            # (3,)*ndim class table: b_raw/(f h^d)
    rhs_const: float


def build_const_template(problem: ProblemSpec) -> ConstTemplate:
    """Assemble the prototype grid and extract the invariant data."""
    if problem.degree != 1 or problem.kappa is not None:
        raise ValueError("const template requires constant-coefficient P1")
    if problem.rhs_const is None:
        raise ValueError("const template requires a constant RHS")
    n0 = 4
    grid = GridLevel(level=0, ndim=problem.ndim, n=n0)
    asm = fa.assemble_level(grid, problem)
    w = detect_const_stencil(asm.offsets, asm.A_planes, asm.interior)
    if w is None:
        raise ValueError("prototype stiffness is not interior-constant")
    center = tuple(n0 // 2 for _ in range(problem.ndim))
    raw_w = tuple(float(asm.A_raw_planes[k][center])
                  for k in range(len(asm.offsets)))
    scale = problem.rhs_const * grid.h ** problem.ndim
    b_pure = _raw_load(grid, problem)
    table = np.zeros((3,) * problem.ndim)
    idx_of_class = {0: 0, 1: 1, 2: n0}   # low edge, interior, high edge
    for cls in np.ndindex(*(3,) * problem.ndim):
        table[cls] = b_pure[tuple(idx_of_class[c] for c in cls)] / scale
    return ConstTemplate(
        proto_n=n0, offsets=asm.offsets, weights=w,
        raw_weights=raw_w, load_table=table, rhs_const=problem.rhs_const,
    )


def _raw_load(grid: GridLevel, problem: ProblemSpec) -> np.ndarray:
    """Raw (no-BC) load vector of the prototype grid."""
    n, h = grid.n, grid.h
    _, _, measure, (qbary, qw) = elements.simplex_p1(grid.ndim)
    b = np.zeros(grid.shape)
    f = problem.rhs_const
    for voffs in fa.simplex_vertex_offsets(grid.ndim, problem.diagonal):
        vol = measure(*[[c * h for c in v] for v in voffs])
        for q in range(len(qw)):
            for a in range(grid.ndim + 1):
                slab = tuple(slice(r, r + n) for r in voffs[a])
                b[slab] += vol * qw[q] * qbary[q, a] * f
    return b


def mass_class_tables(problem: ProblemSpec, n0: int = 4):
    """Consistent-mass boundary-class tables from the prototype grid:
    M[p, p+off] depends only on p's per-axis class.  Verified against the
    assembled prototype.  Returns (offsets, tables (K, 3^d)) at spacing
    h0 = 1/n0; mass scales as h^d."""
    grid = GridLevel(level=0, ndim=problem.ndim, n=n0)
    asm = fa.assemble_level(grid, problem)
    ndim = problem.ndim
    idx_of_class = {0: 0, 1: 1, 2: n0}
    tables = np.zeros((len(asm.M_offsets), 3 ** ndim))
    cls_grid = class_index(grid.shape, grid.points_per_dim, "cpu").numpy()
    for k, plane in enumerate(asm.M_planes):
        for flat, cls in enumerate(np.ndindex(*(3,) * ndim)):
            tables[k, flat] = plane[tuple(idx_of_class[c] for c in cls)]
        if not np.allclose(tables[k][cls_grid], plane, atol=1e-15):
            raise ValueError("mass matrix is not boundary-class constant")
    return asm.M_offsets, tables


def device_level_arrays(template: ConstTemplate, grid: GridLevel,
                        problem: ProblemSpec, dtype: torch.dtype,
                        device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build (b, g) for one level on `device` with torch ops (no host
    O(N) array).  Needs a manufactured solution written as plain
    arithmetic (the built-in polynomial is)."""
    ndim = grid.ndim
    lm = grid.points_per_dim
    shape = grid.shape
    h = grid.h
    exact_fn = problem.resolved_exact()

    def coords(n, shift):
        out = []
        for ax in range(ndim):
            view = [1] * ndim
            view[ax] = n
            i = torch.arange(n, device=device) - shift
            out.append(i.to(dtype).view(view) * h)
        return out

    interior = box_interior_mask(shape, lm, device)
    bc = ~interior
    uD = exact_fn(*coords(lm, 0)).expand(shape)
    g = torch.where(bc, uD, 0.0)

    table = torch.as_tensor(template.load_table, dtype=dtype, device=device)
    cls = class_index(shape, lm, device)
    b_raw = (template.rhs_const * h ** ndim) * table.reshape(-1)[cls]

    # lifting: b <- b_raw - A_raw g on the boundary-padded grid
    wscale = (h * template.proto_n) ** (ndim - 2)
    r = max(max(abs(c) for c in off) for off in template.offsets)
    gp_n = lm + 2 * r
    gp_bc = None
    for ax in range(ndim):
        view = [1] * ndim
        view[ax] = gp_n
        inb = axis_range_mask(gp_n, r, r + lm - 1, device).view(view)
        intr = axis_range_mask(gp_n, r + 1, r + lm - 2, device).view(view)
        gp_bc = (inb, intr) if gp_bc is None else (
            gp_bc[0] & inb, gp_bc[1] & intr)
    gp_mask = (gp_bc[0] & ~gp_bc[1]).expand((gp_n,) * ndim)
    gp = torch.where(gp_mask, exact_fn(*coords(gp_n, r)), 0.0)
    ag = None
    for k, off in enumerate(template.offsets):
        w = template.raw_weights[k] * wscale
        if w == 0.0:
            continue
        sl = tuple(slice(r + o, r + o + s) for o, s in zip(off, shape))
        term = w * gp[sl]
        ag = term if ag is None else ag + term
    b = torch.where(bc, uD, b_raw - ag)
    return b.contiguous(), g.contiguous()

