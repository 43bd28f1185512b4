"""Device-side constant-coefficient P2 level construction.

For constant kappa on the uniform Kuhn mesh the P2 operator on the
half-step DOF lattice is exactly periodic: every interior row depends only
on the node's lattice parity class (vertex, edge, face or body midpoint),
and the only non-periodic raw rows sit on the domain faces.  So the whole
operator is a (K, 4^d) table with per-axis classes {low face, even
interior, odd interior, high face}, taken once from an exact host
assembly of a tiny prototype (n0 = 4 elements, a 9^d lattice) and
rescaled per level: stiffness as h^(d-2), mass and load as h^d.  The
device then builds b and g from index coordinates and the raw tables
(the dolfinx assemble / apply_lifting / set_bc sequence) without a
single host array of the level's size.

Mirrors `multigrid_dolfinx_tpu.fem.fast_p2` with torch ops on an
explicit device, on the logical (2n+1)^d lattice (no TPU tile padding
and no cropped storage).  `device_p2_lmax` (a power iteration from a
`jax.random` start, for Chebyshev) is not ported: ROADMAP.md queue 1,
item 19.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np
import torch

from ..config import ProblemSpec
from ..mesh import GridLevel
from ..ops.operators import (box_interior_mask, parity_axis_class,
                             parity_gather)

Offset = Tuple[int, ...]

# prototype grid: n0 elements per axis -> lattice 2 n0 + 1 = 9.  The
# representative lattice index of each per-axis class {0: low face, 1:
# even interior, 2: odd interior, 3: high face}; the interior ones sit >= 3
# lattice steps from every face, where raw rows are periodic and the load
# carries no lifting.
_P2_N0 = 4
_CLS_REP = {0: 0, 1: 4, 2: 3, 3: 2 * _P2_N0}


@dataclasses.dataclass(frozen=True)
class P2Template:
    """O(1) host data of the device P2 build, unit-normalised in h."""

    ndim: int
    offsets: Tuple[Offset, ...]           # stiffness offsets (radius 2)
    a_unit: np.ndarray                    # (K, 4^d) raw stiffness / h^(d-2)
    m_offsets: Tuple[Offset, ...]
    m_unit: np.ndarray                    # (K_m, 4^d) raw mass / h^d
    load_unit: np.ndarray                 # (4^d,) b_raw / (rhs_const h^d)
    rhs_const: float


def _class_nodes(ndim: int):
    """(flat class index, lattice node index tuple) of all 4^d classes."""
    out = []
    for combo in itertools.product(range(4), repeat=ndim):
        flat = 0
        for c in combo:
            flat = flat * 4 + c
        out.append((flat, tuple(_CLS_REP[c] for c in combo)))
    return out


def build_p2_template(problem: ProblemSpec) -> P2Template:
    """Assemble the n0 = 4 prototype on the host and read off the tables."""
    if problem.degree != 2:
        raise ValueError("build_p2_template is the P2 path")
    if problem.kappa is not None:
        raise ValueError("the device P2 build needs a constant kappa")
    if problem.rhs_const is None:
        raise ValueError("the device P2 build needs a constant RHS")
    if problem.reaction != 0.0:
        raise ValueError("the device P2 build has no reaction term")
    from .assembly import assemble_level

    ndim = problem.ndim
    asm = assemble_level(GridLevel(level=0, ndim=ndim, n=_P2_N0), problem)
    h0 = 1.0 / _P2_N0
    ncls = 4 ** ndim
    a = np.zeros((len(asm.offsets), ncls))
    m = np.zeros((len(asm.M_offsets), ncls))
    load = np.zeros((ncls,))
    for flat, node in _class_nodes(ndim):
        a[:, flat] = asm.A_raw_planes[(slice(None),) + node]
        m[:, flat] = asm.M_planes[(slice(None),) + node]
        if all(2 * _P2_N0 > i > 0 for i in node):
            # interior rows only: boundary rows take uD, and the interior
            # load is parity-periodic at any depth
            load[flat] = asm.b[node] / (problem.rhs_const * h0 ** ndim)
    return P2Template(
        ndim=ndim, offsets=tuple(map(tuple, asm.offsets)),
        a_unit=a / h0 ** (ndim - 2),
        m_offsets=tuple(map(tuple, asm.M_offsets)), m_unit=m / h0 ** ndim,
        load_unit=load, rhs_const=problem.rhs_const,
    )


def level_tables(unit: np.ndarray, scale: float, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """A level's (K, 4^d) tables: unit * scale in f64, then cast to the
    dtype (the JAX build's `a_unit * h ** (d - 2)` and `m_unit * h ** d`),
    so that both packages hold the same numbers."""
    return torch.as_tensor(unit * scale, dtype=dtype, device=device)


def device_p2_level_arrays(template: P2Template, n: int,
                           problem: ProblemSpec, dtype: torch.dtype,
                           device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, g) of one P2 level of n elements per axis on `device`: g = u* on
    the lattice boundary from index coordinates; b = rhs_const h^d
    load[class] - A_raw g on interior rows, uD on boundary rows.  A_raw g
    is O(surface): g lives on the boundary shell, so it is formed face by
    face on 2D planes (each shell node belongs to the face of its lowest
    axis, so edges and corners count once) and subtracted from the (up to
    two) interior planes within the radius-2 stencil of each face."""
    ndim = template.ndim
    lm = 2 * n + 1
    h = 1.0 / n
    delta = h / 2.0                        # lattice spacing
    shape = (lm,) * ndim
    exact_fn = problem.resolved_exact()

    coords = []
    for ax in range(ndim):
        view = [1] * ndim
        view[ax] = lm
        coords.append(torch.arange(lm, device=device).to(dtype).view(view)
                      * delta)
    interior = box_interior_mask(shape, lm, device)
    bc = ~interior
    uD = exact_fn(*coords).expand(shape)
    g = torch.where(bc, uD, 0.0)

    loadw = parity_gather(torch.as_tensor(template.load_unit, dtype=dtype,
                                          device=device), shape, lm)
    b = torch.as_tensor(template.rhs_const * h ** ndim, dtype=dtype) * loadw

    a_tables = torch.as_tensor(template.a_unit * h ** (ndim - 2), dtype=dtype,
                               device=device)
    pshape = (lm,) * (ndim - 1)
    piota = []
    for pa in range(ndim - 1):
        view = [1] * (ndim - 1)
        view[pa] = lm
        piota.append(torch.arange(lm, device=device).view(view))
    pcls = [parity_axis_class(lm, lm, device).view(i.shape) for i in piota]
    for ax in range(ndim):
        in_axes = [a2 for a2 in range(ndim) if a2 != ax]
        for face in (0, lm - 1):
            pcoords = []
            for a2 in range(ndim):
                if a2 == ax:
                    pcoords.append(torch.full(pshape, face * delta,
                                              dtype=dtype, device=device))
                else:
                    pcoords.append(piota[in_axes.index(a2)].to(dtype)
                                   * delta)
            gplane = exact_fn(*pcoords).expand(pshape)
            own = None
            for pa, a2 in enumerate(in_axes):
                i2 = piota[pa]
                m = ((i2 >= 1) & (i2 <= lm - 2)) if a2 < ax else (
                    (i2 >= 0) & (i2 <= lm - 1))
                own = m if own is None else own & m
            gplane = torch.where(own, gplane, 0.0)
            for oax in (-2, -1, 0, 1, 2):
                out_row = face - oax
                if not 0 < out_row < lm - 1:
                    continue           # outside the box, or a bc row (uD)
                c_ax = 1 if out_row % 2 == 0 else 2
                contrib = None
                for k, off in enumerate(template.offsets):
                    if off[ax] != oax:
                        continue
                    idx = [c_ax if a2 == ax else pcls[in_axes.index(a2)]
                           for a2 in range(ndim)]
                    wplane = a_tables[k].view((4,) * ndim)[tuple(idx)]
                    src = gplane
                    for pa, a2 in enumerate(in_axes):
                        o2 = off[a2]
                        if o2:
                            src = torch.roll(src, -o2, dims=pa)
                            valid = ((piota[pa] + o2 >= 0)
                                     & (piota[pa] + o2 <= lm - 1))
                            src = torch.where(valid, src, 0.0)
                    term = wplane * src
                    contrib = term if contrib is None else contrib + term
                if contrib is None:
                    continue
                sl = tuple(out_row if a2 == ax else slice(None)
                           for a2 in range(ndim))
                b[sl] += -contrib
    b = torch.where(bc, uD, b)
    return b.contiguous(), g.contiguous()
