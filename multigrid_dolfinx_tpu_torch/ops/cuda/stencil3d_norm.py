"""Fused residual + FEM-L2 quadratic forms K4 and K38: CUDA wrappers and
plain versions.

K4 residual_tet_quad replaces multigrid_dolfinx_tpu/ops/pallas/
stencil3d_norm.py residual_tet_quad: q = r^T M r with r = f - A v
unmasked (f - v on boundary rows) and M the exact per-tet P1 mass,
computed as h^3/120 * sum_cells [sum_6 tets (sum_4 corners r)^2 +
sum_corners count * r^2].  Bound on the H100: memory, 8 bytes per point
read in f32 (v, f) and nothing grid-sized written.  Design: a block owns
a column tile of cell anchors and marches up a z segment, with rings of
v and f planes in shared memory filled by asynchronous copies and two
planes of r: each step derives r at one plane once a point (about 1.07
times a point at 32 x 32 tiles, against 8 in a per-cell design), and
forms the cells below it, each thread keeping its cells' lower corners in
registers.  Cell values in the working type, added per thread into an f64
sum; blocks reduce in shared memory to one partial each, and a one-block
second pass adds the partials in a fixed order.  No atomics: the sum is
the same on every run, so the per-cycle rtol check cannot move a cycle
count.  The f64 accumulation keeps the sum over 1.3e8 cells from eroding
the f32 floor near rtol 1e-8.  Plane bases are 64-bit: every lm a card
can hold.

K38 residual_mass_quad replaces stencil3d_norm.py residual_mass_quad (its
_norm_kernel and the jnp shell delta _shell_delta_quad): q = r^T M r for
the same r and M any radius-1 class-table operator with the centre offset
and a point-symmetric pattern (an uncertified mass), i.e. q = sum_p r(p)
sum_k T_k[cls(p)] r(p + off_k), r = 0 outside the box.  Bound on the
H100: memory, as K4.  Design: the wrapper lays the tables out dense, 27 x
27 [offset][class] in the working type with a bit mask of the offsets
present; a block derives r on an 8 x 8 x 32 tile plus a 1-point halo into
shared memory and forms each point's product over the present offsets in
offset order ((dz+1)*9 + (dy+1)*3 + (dx+1)), in the working type, into an
f64 sum; partials are added in a fixed order, as K4's.  The result is a
0-dim f64 tensor; the TPU kernel returns f32.  It admits every lm <=
MAX_LM and refuses, on every device, an operator outside those conditions
(the JAX kernel's operator conditions; its TPU layout ones do not apply
to unpadded storage).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build
from .stencil3d import (check_lm, check_tensor, residual_ref, stream,
                        suffix)
from ..operators import class_index
from ...fem.assembly import simplex_vertex_offsets

LAUNCHES = {"residual_tet_quad": 0, "residual_mass_quad": 0}
DIAGONALS = {"right": 0, "left": 1}


def tet_tables(diagonal: str):
    """(tets, counts): the 6 Kuhn tets as corner offsets (dz, dy, dx), and
    each corner's tet count in first-appearance order."""
    tets = [tuple(tuple(int(c) for c in corner) for corner in tet)
            for tet in simplex_vertex_offsets(3, diagonal)]
    counts = {}
    for tet in tets:
        for corner in tet:
            counts[corner] = counts.get(corner, 0) + 1
    return tets, counts


def _scale(lm: int) -> float:
    return (1.0 / (lm - 1)) ** 3 / 120.0


def residual_tet_quad(v: torch.Tensor, f: torch.Tensor, lm: int, wc: float,
                      woff: float, diagonal: str) -> torch.Tensor:
    """q = r^T M r as a 0-dim f64 tensor on v's device."""
    shape = (lm,) * 3
    check_tensor(v, "v", shape)
    check_tensor(f, "f", shape, v.dtype)
    lib = build.library()
    out = torch.empty(1, dtype=torch.float64, device=v.device)
    fn = getattr(lib, f"mg_residual_tet_quad_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        # the grid, and so the partial count, follows the card's occupancy
        nparts = lib.mg_tet_quad_partials(lm)
        if nparts <= 0:
            raise RuntimeError("residual_tet_quad: the kernel's shared memory "
                               "was refused")
        partials = torch.empty(nparts, dtype=torch.float64, device=v.device)
        err = fn(v.data_ptr(), f.data_ptr(), partials.data_ptr(),
                 out.data_ptr(), lm, wc, woff, DIAGONALS[diagonal],
                 _scale(lm), stream(v))
    build.check(err, "residual_tet_quad")
    LAUNCHES["residual_tet_quad"] += 1
    return out[0]


def residual_tet_quad_ref(v: torch.Tensor, f: torch.Tensor, lm: int,
                          wc: float, woff: float,
                          diagonal: str) -> torch.Tensor:
    """Plain version of residual_tet_quad (cell values in the working
    type, summed in f64)."""
    r = residual_ref(v, f, lm, wc, woff)
    nc = lm - 1
    tets, counts = tet_tables(diagonal)

    def corner(c):
        return r[c[0]:c[0] + nc, c[1]:c[1] + nc, c[2]:c[2] + nc]

    acc = torch.zeros((nc,) * 3, dtype=v.dtype, device=v.device)
    for c, cnt in counts.items():
        acc = acc + float(cnt) * corner(c) * corner(c)
    for tet in tets:
        t = ((corner(tet[0]) + corner(tet[1])) + corner(tet[2])) + corner(tet[3])
        acc = acc + t * t
    return torch.sum(acc, dtype=torch.float64) * _scale(lm)


def offset_index(off) -> int:
    """K38's dense offset index of a radius-1 3D offset (dz, dy, dx)."""
    dz, dy, dx = off
    return (dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)


def mass_quad_refusal(tables: torch.Tensor, offsets):
    """Why K38 does not compute r^T M r for class tables `tables` on
    `offsets`, or None where it does: 3D offsets of radius 1, distinct,
    the centre among them, every -off beside off, tables of shape (K,
    27)."""
    offsets = tuple(map(tuple, offsets))
    if any(len(off) != 3 for off in offsets):
        return "offsets are not 3D"
    if any(max(abs(a) for a in off) > 1 for off in offsets):
        return "offsets reach beyond radius 1"
    if len(set(offsets)) != len(offsets):
        return "offsets repeat"
    if (0, 0, 0) not in offsets:
        return "no centre offset"
    if any(tuple(-a for a in off) not in offsets for off in offsets):
        return "the offset pattern is not point-symmetric"
    if tuple(tables.shape) != (len(offsets), 27):
        return (f"tables of shape {tuple(tables.shape)}, not "
                f"({len(offsets)}, 27)")
    return None


def _check_operator(tables, offsets) -> None:
    why = mass_quad_refusal(tables, offsets)
    if why is not None:
        raise ValueError(f"residual_mass_quad: {why}")


def residual_mass_quad(v: torch.Tensor, f: torch.Tensor,
                       tables: torch.Tensor, offsets, lm: int, wc: float,
                       woff: float) -> torch.Tensor:
    """q = r^T M r with M the class-table operator (tables, offsets), as a
    0-dim f64 tensor on v's device."""
    check_lm(lm)
    shape = (lm,) * 3
    check_tensor(v, "v", shape)
    check_tensor(f, "f", shape, v.dtype)
    _check_operator(tables, offsets)
    idx = [offset_index(off) for off in offsets]
    dense = torch.zeros((27, 27), dtype=v.dtype, device=v.device)
    dense[idx] = tables.to(device=v.device, dtype=v.dtype)
    mask = sum(1 << k for k in idx)
    lib = build.library()
    partials = torch.empty(lib.mg_mass_quad_partials(lm), dtype=torch.float64,
                           device=v.device)
    out = torch.empty(1, dtype=torch.float64, device=v.device)
    fn = getattr(lib, f"mg_residual_mass_quad_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), f.data_ptr(), dense.data_ptr(), mask,
                 partials.data_ptr(), out.data_ptr(), lm, wc, woff, stream(v))
    build.check(err, "residual_mass_quad")
    LAUNCHES["residual_mass_quad"] += 1
    return out[0]


def residual_mass_quad_ref(v: torch.Tensor, f: torch.Tensor,
                           tables: torch.Tensor, offsets, lm: int, wc: float,
                           woff: float) -> torch.Tensor:
    """Plain version of residual_mass_quad: residual_ref, then the
    class-table product (StencilOperator._apply_class_tables) over the
    offsets in K38's order, in the working type, summed in f64."""
    _check_operator(tables, offsets)
    r = residual_ref(v, f, lm, wc, woff)
    cls = class_index(r.shape, lm, r.device)
    t = tables.to(device=r.device, dtype=r.dtype)
    rp = F.pad(r, (1, 1) * 3)
    acc = torch.zeros_like(r)
    order = sorted(range(len(offsets)), key=lambda k: offset_index(offsets[k]))
    for k in order:
        sl = tuple(slice(1 + o, 1 + o + lm) for o in offsets[k])
        acc = acc + t[k][cls] * rp[sl]
    return torch.sum(r * acc, dtype=torch.float64)
