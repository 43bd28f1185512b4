"""Fused residual + FEM-L2 quadratic form K4: CUDA wrapper and plain version.

K4 residual_tet_quad replaces multigrid_dolfinx_tpu/ops/pallas/
stencil3d_norm.py residual_tet_quad: q = r^T M r with r = f - A v
unmasked (f - v on boundary rows) and M the exact per-tet P1 mass,
computed as h^3/120 * sum_cells [sum_6 tets (sum_4 corners r)^2 +
sum_corners count * r^2].  Bound on the H100: memory, 8 bytes per point
read in f32 (v, f) and nothing grid-sized written.  Design: one thread
per cell anchor in a grid-stride loop derives r at its 8 corners from v
and f (neighbours through L1/L2), forms the cell value in the working
type, and adds it to a per-thread f64 sum; blocks reduce in shared memory
to one partial each, and a one-block second pass adds the partials in a
fixed order.  No atomics: the sum is the same on every run, so the
per-cycle rtol check cannot move a cycle count.  The f64 accumulation
keeps the sum over 1.3e8 cells from eroding the f32 floor near rtol 1e-8.
"""
from __future__ import annotations

import torch

from . import build
from .stencil3d import check_tensor, residual_ref, stream, suffix
from ...fem.assembly import simplex_vertex_offsets

LAUNCHES = {"residual_tet_quad": 0}
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
    partials = torch.empty(lib.mg_tet_quad_partials(lm), dtype=torch.float64,
                           device=v.device)
    out = torch.empty(1, dtype=torch.float64, device=v.device)
    fn = getattr(lib, f"mg_residual_tet_quad_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
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
