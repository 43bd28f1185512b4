"""Const-5-point kernels K30-K34 on a row strip of a distributed 2D level:
CUDA wrappers and plain versions.

A rank's strip is (m, lm), contiguous, unpadded in columns; its global
row starts at row_base, and rows at global index >= lm are plan padding
(written as 0).  The neighbours' rows come as separate (h, lm) arrays:
`lo` the -row neighbour's last h rows, `hi` the +row neighbour's first h
rows, zeros at the domain edge.  Each `name(...)` launches the
hand-written Hopper kernel of `csrc/stencil2d_dist.cu` on CUDA tensors
(and raises on anything else); each `name_ref(...)` is its plain PyTorch
version, which concatenates the halos (the kernels read them through a
window instead) and keeps the kernel's association order.  Stitched over
the ranks, each equals the single-device kernel (K6, K5, K7, K8, v + K9)
on the global array bitwise.  The operator is the P1 stiffness (-1, -1,
4, -1, -1) the single-device kernels hard-code (ops.dispatch.
require_const5).

K30 rb_sweep_dist_2d replaces multigrid_dolfinx_tpu/ops/pallas/
  stencil2d_dist.py rb_sweep_dist (2-deep halos of v and f).  Design:
  K6's two launches; the red launch covers the strip and one halo row
  each side (the halo rows' red values go to a 2-row scratch), the black
  launch updates the strip in place from the red values.  Bound: memory,
  v, f and out once, as K6.  K30-K34 run one thread per point in K5's
  32 x 8 blocks.
K31 jacobi_sweep_dist_2d replaces jacobi_sweep_dist (1-deep halos of v):
  K5's (keep v + nbr s) + wdf df with df = dinv f hoisted by the caller,
  out of place.  The TPU kernel computes (1-w) v + w cand instead; K31
  keeps K5's association so the stitched sweep is bitwise K5's.
K32 residual_dist_2d replaces residual_dist (1-deep halos of v): K7's
  f - (4 v~ - S(v~)), boundary rows f - v.
K33 restrict_pt_dist_2d replaces restrict_pt_dist: K8's masked [1 2 1]^2
  (rows, then columns) times 1/4 onto the local coarse strip (m/2, lmc),
  whose global rows start at row_base / 2 (row_base even).  Coarse row i
  centres on fine row 2 i <= m - 2, so it reads the -row neighbour's last
  row (`rlo`) and nothing of the +row neighbour.
K34 prolong_add_dist_2d replaces prolong_add_dist: K9's bilinear
  prolongation (columns, then rows) of the local coarse strip onto the
  fine strip (2 mc rows), the last odd fine row interpolating towards
  `chi`, the +row neighbour's first coarse row; fused with the
  correction v + P(c) when v is given, P(c) alone when it is not (the
  TPU kernel always takes v and is handed zeros for a plain
  prolongation).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import build
from .stencil2d import nbr_sum_ref
from .stencil3d import check_tensor, combine121, interp_axis, stream, suffix

#: Calls of each wrapper that launched its kernel(s) (rb_sweep_dist_2d is
#: two launches per call).  Reset with ops.cuda.reset_launch_counts().
LAUNCHES = {"rb_sweep_dist_2d": 0, "jacobi_sweep_dist_2d": 0,
            "residual_dist_2d": 0, "restrict_pt_dist_2d": 0,
            "prolong_add_dist_2d": 0}


def row_coords(m: int, lm: int, row_base: int, device):
    """Global (row, column) index views of an (m, lm) strip whose row 0
    lies at global row row_base."""
    i = (torch.arange(m, device=device) + row_base).view(-1, 1)
    return i, torch.arange(lm, device=device).view(1, -1)


def strip_interior(m: int, lm: int, row_base: int, device) -> torch.Tensor:
    """Interior mask (1 <= index <= lm-2 on both axes, rows global) of an
    (m, lm) strip whose row 0 lies at global row row_base."""
    i, j = row_coords(m, lm, row_base, device)
    return (((i >= 1) & (i <= lm - 2)) & ((j >= 1) & (j <= lm - 2))).expand(
        m, lm)


def strip_inbox(m: int, lm: int, row_base: int, device) -> torch.Tensor:
    """(m, 1) mask of the strip's rows at global index <= lm - 1."""
    return row_coords(m, lm, row_base, device)[0] <= lm - 1


def _check_strip(v, others, halos, h, lm, row_base, name):
    m = v.shape[0]
    check_tensor(v, f"{name} v", (m, lm))
    for label, t in others:
        check_tensor(t, f"{name} {label}", (m, lm), v.dtype)
    for label, t in halos:
        check_tensor(t, f"{name} {label}", (h, lm), v.dtype)
    if m < 1 or lm < 3:
        raise ValueError(f"{name}: empty strip ({m} x {lm})")
    if row_base < 0:
        raise ValueError(f"{name}: row_base {row_base} < 0")
    return m


def _check_even(m: int, row_base: int, name: str) -> None:
    if m % 2 or row_base % 2:
        raise ValueError(f"{name}: the strip ({m} rows at row {row_base}) "
                         "must start at an even row and hold an even count")


def _launch(name, v, *args):
    fn = getattr(build.library(), f"mg_{name}_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        build.check(fn(*args, stream(v)), name)
    LAUNCHES[name] += 1


# ----------------------------------------------------------------------
# K30: red-black Gauss-Seidel sweep on a strip
# ----------------------------------------------------------------------

def rb_sweep_dist_2d(v, f, vlo, vhi, flo, fhi, lm: int,
                     row_base: int) -> torch.Tensor:
    """One full red-black GS sweep of the strip with 2-deep halos of v
    and f; row_base must be even (the plan's quantum makes it so)."""
    m = _check_strip(v, (("f", f),), (("vlo", vlo), ("vhi", vhi),
                                      ("flo", flo), ("fhi", fhi)), 2, lm,
                     row_base, "rb_sweep_dist_2d")
    _check_even(m, row_base, "rb_sweep_dist_2d")
    out = torch.empty_like(v)
    scratch = torch.empty((2, lm), dtype=v.dtype, device=v.device)
    _launch("rb_sweep_dist_2d", v, v.data_ptr(), f.data_ptr(),
            vlo.data_ptr(), vhi.data_ptr(), flo.data_ptr(), fhi.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), m, lm, row_base)
    return out


def rb_sweep_dist_2d_ref(v, f, vlo, vhi, flo, fhi, lm: int,
                         row_base: int) -> torch.Tensor:
    """Plain version of rb_sweep_dist_2d: K6's plain sweep on the strip
    extended by its halos (global rows from row_base - 2), cropped,
    padding rows 0."""
    m = v.shape[0]
    _check_even(m, row_base, "rb_sweep_dist_2d")
    ve, fe = torch.cat([vlo, v, vhi]), torch.cat([flo, f, fhi])
    interior = strip_interior(m + 4, lm, row_base - 2, v.device)
    i, j = row_coords(m + 4, lm, row_base - 2, v.device)
    parity = (i + j) % 2
    cur = ve
    for color in (0, 1):
        vt = torch.where(interior, cur, 0.0)
        cand = torch.where(interior, (fe + nbr_sum_ref(vt)) * 0.25, fe)
        cur = torch.where(parity == color, cand, cur)
    return torch.where(strip_inbox(m, lm, row_base, v.device), cur[2:-2],
                       0.0)


# ----------------------------------------------------------------------
# K31: weighted Jacobi sweep on a strip
# ----------------------------------------------------------------------

def jacobi_sweep_dist_2d(v, df, vlo, vhi, lm: int, w: float,
                         row_base: int) -> torch.Tensor:
    """One weighted-Jacobi sweep of the strip from v (1-deep halos) with
    the hoisted df = dinv * f, into a fresh tensor."""
    m = _check_strip(v, (("df", df),), (("vlo", vlo), ("vhi", vhi)), 1, lm,
                     row_base, "jacobi_sweep_dist_2d")
    out = torch.empty_like(v)
    _launch("jacobi_sweep_dist_2d", v, v.data_ptr(), df.data_ptr(),
            vlo.data_ptr(), vhi.data_ptr(), out.data_ptr(), m, lm, row_base,
            1.0 - w, w * 0.25, w)
    return out


def jacobi_sweep_dist_2d_ref(v, df, vlo, vhi, lm: int, w: float,
                             row_base: int) -> torch.Tensor:
    """Plain version of jacobi_sweep_dist_2d: ((1-w) v + (w/4) s) + w df,
    s the masked neighbour sum inside and 0 on the boundary, padding rows
    0."""
    m = v.shape[0]
    interior = strip_interior(m + 2, lm, row_base - 1, v.device)
    vt = torch.where(interior, torch.cat([vlo, v, vhi]), 0.0)
    s = torch.where(interior, nbr_sum_ref(vt), 0.0)[1:-1]
    out = ((1.0 - w) * v + (w * 0.25) * s) + w * df
    return torch.where(strip_inbox(m, lm, row_base, v.device), out, 0.0)


# ----------------------------------------------------------------------
# K32: residual on a strip
# ----------------------------------------------------------------------

def residual_dist_2d(v, f, vlo, vhi, lm: int, row_base: int) -> torch.Tensor:
    """r = f - A v of the strip with 1-deep halos of v, into a fresh
    tensor."""
    m = _check_strip(v, (("f", f),), (("vlo", vlo), ("vhi", vhi)), 1, lm,
                     row_base, "residual_dist_2d")
    out = torch.empty_like(v)
    _launch("residual_dist_2d", v, v.data_ptr(), f.data_ptr(),
            vlo.data_ptr(), vhi.data_ptr(), out.data_ptr(), m, lm, row_base)
    return out


def residual_dist_2d_ref(v, f, vlo, vhi, lm: int,
                         row_base: int) -> torch.Tensor:
    """Plain version of residual_dist_2d: f - where(interior, 4 v~ -
    S(v~), v) on the strip, padding rows 0."""
    m = v.shape[0]
    interior = strip_interior(m + 2, lm, row_base - 1, v.device)
    vt = torch.where(interior, torch.cat([vlo, v, vhi]), 0.0)
    av = (4.0 * vt - nbr_sum_ref(vt))[1:-1]
    r = f - torch.where(interior[1:-1], av, v)
    return torch.where(strip_inbox(m, lm, row_base, v.device), r, 0.0)


# ----------------------------------------------------------------------
# K33: masked P^T restriction on a strip
# ----------------------------------------------------------------------

def _check_levels(lmf: int, lmc: int) -> None:
    if lmf != 2 * lmc - 1:
        raise ValueError(f"lmf={lmf} is not 2*lmc-1 for lmc={lmc}")


def restrict_pt_dist_2d(r, rlo, lmf: int, lmc: int,
                        row_base: int) -> torch.Tensor:
    """The local coarse strip (m/2, lmc) of P^T r from the fine strip r
    and the -row neighbour's last row rlo (1, lmf)."""
    m = _check_strip(r, (), (("rlo", rlo),), 1, lmf, row_base,
                     "restrict_pt_dist_2d")
    _check_even(m, row_base, "restrict_pt_dist_2d")
    _check_levels(lmf, lmc)
    out = torch.empty((m // 2, lmc), dtype=r.dtype, device=r.device)
    _launch("restrict_pt_dist_2d", r, r.data_ptr(), rlo.data_ptr(),
            out.data_ptr(), m, lmf, lmc, row_base)
    return out


def restrict_pt_dist_2d_ref(r, rlo, lmf: int, lmc: int,
                            row_base: int) -> torch.Tensor:
    """Plain version of restrict_pt_dist_2d: r extended by rlo, masked to
    the fine interior, [1 2 1] combined along rows, then (zero-padded)
    columns, times 0.25, the coarse boundary (global coarse rows from
    row_base / 2) zeroed."""
    m = r.shape[0]
    _check_even(m, row_base, "restrict_pt_dist_2d")
    _check_levels(lmf, lmc)
    interior = strip_interior(m + 1, lmf, row_base - 1, r.device)
    rt = torch.where(interior, torch.cat([rlo, r]), 0.0)
    g = combine121(F.pad(combine121(rt, 0), (1, 1)), 1)
    mask = strip_interior(m // 2, lmc, row_base // 2, r.device)
    return torch.where(mask, g * 0.25, 0.0)


# ----------------------------------------------------------------------
# K34: bilinear prolongation (+ fused correction) on a strip
# ----------------------------------------------------------------------

def prolong_add_dist_2d(c, chi, lmf: int, row_base: int,
                        v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P(c) on the local fine strip (2 mc, lmf), or v + P(c) when v is
    given; chi is the +row neighbour's first coarse row (1, lmc)."""
    mc, lmc = c.shape
    _check_levels(lmf, lmc)
    _check_even(2 * mc, row_base, "prolong_add_dist_2d")
    check_tensor(c, "prolong_add_dist_2d c", (mc, lmc))
    check_tensor(chi, "prolong_add_dist_2d chi", (1, lmc), c.dtype)
    if mc < 1:
        raise ValueError("prolong_add_dist_2d: empty strip")
    if v is not None:
        check_tensor(v, "prolong_add_dist_2d v", (2 * mc, lmf), c.dtype)
    out = torch.empty((2 * mc, lmf), dtype=c.dtype, device=c.device)
    _launch("prolong_add_dist_2d", c, c.data_ptr(), chi.data_ptr(),
            None if v is None else v.data_ptr(), out.data_ptr(), mc, lmc,
            lmf, row_base)
    return out


def prolong_add_dist_2d_ref(c, chi, lmf: int, row_base: int,
                            v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of prolong_add_dist_2d: K9's plain interpolation
    (columns, then rows) of the strip extended by chi, cropped to 2 mc
    fine rows, rows at global index > lmf - 1 zero."""
    mc = c.shape[0]
    _check_levels(lmf, c.shape[1])
    _check_even(2 * mc, row_base, "prolong_add_dist_2d")
    e = interp_axis(interp_axis(torch.cat([c, chi]), 1), 0)[:2 * mc]
    e = torch.where(strip_inbox(2 * mc, lmf, row_base, c.device), e, 0.0)
    return e if v is None else v + e
