"""Device-side variable-coefficient P1 hierarchy construction (torch).

Mirrors `multigrid_dolfinx_tpu.fem.fast_var`.  For P1 on the structured
simplex grid every array of a level is a closed-form function of the
per-cell coefficient fields kappa_s[c] = kappa(centroid of simplex s in
cell c), so the build runs as torch ops on the target device:

    A_raw[off][p] = sum_{s,(a,b): v_b - v_a = off} K_s[a,b] kappa_s[p - v_a]

then Dirichlet elimination and lifting as masked updates, and the Galerkin
product P^T A P as one strided 2D or 3D convolution.  The host does O(1) work:
the element matrices K_s and the boundary-class load and mass tables.

Storage is the logical (n+1)^d box; the TPU's tile padding
(`embed_planes`, `embed_grid`), its z-chunked convolution and its
staged-build barriers answer TPU memory and runtime limits and are not
ported.  The power-iteration lmax of the Chebyshev window
(`device_lmax_dinv_a`) is ROADMAP.md queue 1, item 19.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ProblemSpec
from ..mesh import GridLevel
from ..ops.operators import box_interior_mask, class_index, stencil_radius
from . import assembly as fa
from . import elements
from .fast_const import build_const_template, mass_class_tables

Offset = Tuple[int, ...]


def structural_offsets(ndim: int, diagonal: str) -> Tuple[Offset, ...]:
    """The nonzero-offset set of a P1 operator on this simplex split: the
    pairwise vertex differences, 7 in 2D and 15 on the 3D Kuhn mesh."""
    offs = set()
    for voffs in fa.simplex_vertex_offsets(ndim, diagonal):
        for va in voffs:
            for vb in voffs:
                offs.add(tuple(b - a for a, b in zip(va, vb)))
    return tuple(sorted(offs))


@dataclasses.dataclass(frozen=True)
class VarTemplate:
    """O(1) host data of the device build: per simplex its vertex
    offsets, centroid (cell units) and element stiffness at h = 1, plus
    the boundary-class load and mass tables."""

    ndim: int
    diagonal: str
    offsets: Tuple[Offset, ...]
    simplices: Tuple[Tuple[Tuple[Offset, ...], Tuple[float, ...],
                           np.ndarray], ...]
    load_table: np.ndarray            # (3,)*ndim, b_raw / (f h^d)
    mass_offsets: Tuple[Offset, ...]
    mass_tables: np.ndarray           # (K_m, 3^d) at prototype h0 = 1/4
    rhs_const: float
    reaction: float


def build_var_template(problem: ProblemSpec) -> VarTemplate:
    if problem.degree != 1:
        raise ValueError("device variable-coefficient build requires P1")
    if problem.rhs_const is None:
        raise ValueError("device variable-coefficient build requires a "
                         "constant RHS")
    ndim = problem.ndim
    stiffness = elements.simplex_p1(ndim)[0]
    simplices = []
    for voffs in fa.simplex_vertex_offsets(ndim, problem.diagonal):
        # stiffness scales as h^(d-2): computed at h = 1, rescaled per level
        K = stiffness(*[tuple(float(c) for c in v) for v in voffs])
        centroid = tuple(float(np.mean([v[a] for v in voffs]))
                         for a in range(ndim))
        simplices.append((tuple(voffs), centroid, np.asarray(K)))
    const_prob = dataclasses.replace(problem, kappa=None, reaction=0.0)
    m_offsets, m_tables = mass_class_tables(const_prob)
    return VarTemplate(
        ndim=ndim, diagonal=problem.diagonal,
        offsets=structural_offsets(ndim, problem.diagonal),
        simplices=tuple(simplices),
        load_table=build_const_template(const_prob).load_table,
        mass_offsets=tuple(map(tuple, m_offsets)), mass_tables=m_tables,
        rhs_const=problem.rhs_const, reaction=problem.reaction,
    )


def _axis_coord(n: int, axis: int, ndim: int, shift: float, h: float,
                dtype, device) -> torch.Tensor:
    """(iota + shift) * h along `axis`, broadcastable, in the build dtype."""
    view = [1] * ndim
    view[axis] = n
    return ((torch.arange(n, device=device).to(dtype) + shift) * h).view(view)


def device_raw_planes(template: VarTemplate, grid: GridLevel, kappa_fn,
                      dtype: torch.dtype, device) -> torch.Tensor:
    """Raw (pre-elimination) stiffness planes (K, (n+1)^d) on `device`.
    Each (simplex, a, b) term is one shifted multiply-add of the simplex's
    kappa field, accumulated per offset in the JAX package's order."""
    ndim, n, h = grid.ndim, grid.n, grid.h
    node_shape = (n + 1,) * ndim
    cell_shape = (n,) * ndim
    koff = {off: k for k, off in enumerate(template.offsets)}
    wscale = h ** (ndim - 2)

    planes = torch.zeros((len(template.offsets),) + node_shape, dtype=dtype,
                         device=device)
    touched = set()
    for voffs, centroid, K in template.simplices:
        coords = [_axis_coord(n, ax, ndim, centroid[ax], h, dtype, device)
                  for ax in range(ndim)]
        kfield = torch.as_tensor(kappa_fn(*coords), dtype=dtype,
                                 device=device).expand(cell_shape)
        # the contribution at node p is kappa_s[p - v_a]: the padded field
        # sliced at 1 - v_a
        kpad = F.pad(kfield, (1, 1) * ndim)
        del kfield
        for a, va in enumerate(voffs):
            shifted = kpad[tuple(slice(1 - v, 1 - v + n + 1) for v in va)]
            for b, vb in enumerate(voffs):
                k = koff[tuple(q - p for p, q in zip(va, vb))]
                term = float(K[a, b]) * wscale * shifted
                if k in touched:
                    planes[k].add_(term)
                else:
                    planes[k].copy_(term)
                    touched.add(k)
        del kpad

    if template.reaction != 0.0:
        # A_raw += c M: the consistent mass is kappa-independent and
        # boundary-class constant, so its class tables expand in place
        mscale = template.reaction * (h * 4.0) ** ndim
        cls = class_index(node_shape, n + 1, device)
        tables = torch.as_tensor(template.mass_tables, dtype=dtype,
                                 device=device)
        moff = {off: k for k, off in enumerate(template.mass_offsets)}
        for k, off in enumerate(template.offsets):
            if off in moff:
                planes[k].add_(mscale * tables[moff[off]][cls])
    return planes


def eliminate_dirichlet_device(offsets, planes: torch.Tensor,
                               lm: int) -> torch.Tensor:
    """Symmetric Dirichlet elimination of logical planes, in place: bc rows
    and columns zeroed, unit diagonal on bc rows (dolfinx
    assemble_matrix(bcs=...) semantics).  Returns `planes`."""
    shape = tuple(planes.shape[1:])
    ndim = len(shape)
    offsets = tuple(map(tuple, offsets))
    center = offsets.index((0,) * ndim)
    interior = box_interior_mask(shape, lm, planes.device)
    r = stencil_radius(offsets)
    ipad = F.pad(interior, (r, r) * ndim)
    for k, off in enumerate(offsets):
        keep = interior & ipad[tuple(slice(r + o, r + o + s)
                                     for o, s in zip(off, shape))]
        planes[k].masked_fill_(~keep, 0.0)
    planes[center].masked_fill_(~interior, 1.0)
    return planes


def device_level_b_g(template: VarTemplate, grid: GridLevel,
                     problem: ProblemSpec, raw_planes: torch.Tensor,
                     dtype: torch.dtype):
    """(b, g) of a level on the planes' device: class-table raw load,
    lifting b_raw - A_raw g with the level's raw planes, set_bc (the
    dolfinx sequence)."""
    ndim, n, h = grid.ndim, grid.n, grid.h
    shape = (n + 1,) * ndim
    lm = n + 1
    device = raw_planes.device
    coords = [_axis_coord(lm, ax, ndim, 0.0, h, dtype, device)
              for ax in range(ndim)]
    bc = ~box_interior_mask(shape, lm, device)
    uD = torch.as_tensor(problem.resolved_exact()(*coords), dtype=dtype,
                         device=device).expand(shape)
    g = torch.where(bc, uD, 0.0)

    table = torch.as_tensor(template.load_table, dtype=dtype, device=device)
    b_raw = (template.rhs_const * h ** ndim) * table.reshape(-1)[
        class_index(shape, lm, device)]

    r = stencil_radius(template.offsets)
    gpad = F.pad(g, (r, r) * ndim)
    ag = None
    for k, off in enumerate(template.offsets):
        term = raw_planes[k] * gpad[tuple(slice(r + o, r + o + s)
                                          for o, s in zip(off, shape))]
        ag = term if ag is None else ag + term
    b = torch.where(bc, uD, b_raw - ag)
    return b.contiguous(), g.contiguous()


def galerkin_weights(offsets, ndim: int) -> Tuple[Tuple[Offset, ...],
                                                  np.ndarray]:
    """(coarse offsets = the full 3^d box, W[D, d, e]) of the RAP
    convolution: W = w(e) w(e + d - 2D) where |e + d - 2D|_inf <= 1, w(v) =
    0.5^(number of nonzero components)."""
    def w(v):
        return 0.5 ** sum(1 for c in v if c != 0)

    coarse_offsets = tuple(sorted(itertools.product((-1, 0, 1), repeat=ndim)))
    W = np.zeros((len(coarse_offsets), len(offsets)) + (3,) * ndim)
    for kD, D in enumerate(coarse_offsets):
        for kd, d in enumerate(offsets):
            for e in itertools.product((-1, 0, 1), repeat=ndim):
                t = tuple(ea + da - 2 * Da for ea, da, Da in zip(e, d, D))
                if any(abs(c) > 1 for c in t):
                    continue
                W[(kD, kd) + tuple(ea + 1 for ea in e)] = w(e) * w(t)
    return coarse_offsets, W


def galerkin_rap_device(offsets, planes: torch.Tensor, lm_f: int):
    """Galerkin product A_c = P^T A_f P of a radius-1 fine operator with
    multilinear P, on the planes' device:

        A_c[D][I] = sum_{e,d} w(e) w(e+d-2D) A_f[d][2I+e]

    is one strided convolution (the K fine planes are input channels, the
    3^d coarse offsets output channels, window e in {-1,0,1}^d, stride 2,
    padding 1), computed by the library convolution as the JAX package
    does with lax.conv_general_dilated.  In full precision: cuDNN's
    default TF32 would round the products to ~1e-3 (the twin of the
    bf16-pass error the JAX package fixed with Precision.HIGHEST).
    Returns (coarse offsets, coarse planes), not eliminated."""
    offsets = tuple(map(tuple, offsets))
    ndim = len(offsets[0])
    lm_c = (lm_f - 1) // 2 + 1
    coarse_offsets, W = galerkin_weights(offsets, ndim)
    Wt = torch.as_tensor(W, dtype=planes.dtype, device=planes.device)
    conv = F.conv2d if ndim == 2 else F.conv3d
    # enabled=True: cudnn.flags() would switch cuDNN off by default
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    allow_tf32=False):
        out = conv(planes[None], Wt, stride=2, padding=1)[0]
    assert out.shape == (len(coarse_offsets),) + (lm_c,) * ndim
    return coarse_offsets, out
