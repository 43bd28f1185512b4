"""Const-5-point multigrid kernels K5-K9: CUDA wrappers and plain versions.

Each `name(...)` launches the hand-written Hopper kernel of
`csrc/stencil2d.cu` on a CUDA tensor (and raises on anything else); each
`name_ref(...)` is its plain PyTorch version with the same association
order, which the CPU path and the on-card comparison use.  Arrays are the
logical lm^2 node box, contiguous, f32 or f64.  The operator is the 2D P1
stiffness (-1, -1, 4, -1, -1) with identity boundary rows; the callers
check the weights (ops.dispatch.const5_ok).

K5 jacobi_sweep replaces multigrid_dolfinx_tpu/ops/pallas/stencil2d.py
  jacobi_sweep: (1-w) v + (w/4) S(v~) + w df, boundary rows mixed.
  Bound: memory, 8 bytes read (v, df) and 4 written per point in f32.
K6 rb_sweep replaces stencil2d.py rb_sweep.  Design: one launch per
  colour, one thread per point; the red launch writes every point of
  `out`, the black launch updates `out` in place (the TPU kernel does
  both colours in one pass from VMEM; fusing them with a recomputed red
  halo in shared memory is later work).  Bound: memory, two passes of
  8 bytes read and 4 written per point.
K7 residual replaces stencil2d.py residual: f - (4 v~ - S(v~)) inside,
  f - v on the boundary.  Bound: memory, 8 bytes read, 4 written.
K8 restrict_pt replaces stencil2d.py restrict_pt: the masked [1 2 1]^2
  of r (rows, then columns) at even fine points, times 1/4, 0 off the
  coarse interior.  Bound: memory, the fine r read once (neighbouring
  coarse threads share their fine rows through L1/L2).
K9 prolong_linear replaces stencil2d.py prolong_linear: columns, then
  rows, each midpoint 0.5 (a + b).  Bound: memory, 4 bytes written per
  fine point; the coarse array is 1/4 of that and stays in L2.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build
from ..operators import box_interior_mask
from .stencil3d import check_tensor, combine121, interp_axis, stream, suffix

#: Calls of each wrapper that launched its kernel(s) (rb_sweep_2d is two
#: colour launches per call).  Reset with ops.cuda.reset_launch_counts().
LAUNCHES = {"jacobi_sweep_2d": 0, "rb_sweep_2d": 0, "residual_2d": 0,
            "restrict_pt_2d": 0, "prolong_linear_2d": 0}

#: Largest lm whose lm^2 point index fits the kernels' 32-bit ints.
MAX_LM = 46340


def _check_lm(*lms: int) -> None:
    for lm in lms:
        if not 3 <= lm <= MAX_LM:
            raise ValueError(f"lm={lm} outside the kernels' range "
                             f"3..{MAX_LM} (32-bit point indices)")


def _check_levels(lmf: int, lmc: int) -> None:
    if lmf != 2 * lmc - 1:
        raise ValueError(f"lmf={lmf} is not 2*lmc-1 for lmc={lmc}")


def _call(name: str, dtype: torch.dtype, device, *args) -> None:
    fn = getattr(build.library(), f"mg_{name}_{suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(*args)
    build.check(err, name)
    LAUNCHES[name] += 1


def nbr_sum_ref(vt: torch.Tensor) -> torch.Tensor:
    """(i-1) + (i+1) + (j-1) + (j+1) of an interior-masked field, zero
    beyond the box."""
    p = F.pad(vt, (1, 1, 1, 1))
    c = slice(1, -1)
    return ((p[:-2, c] + p[2:, c]) + p[c, :-2]) + p[c, 2:]


# ----------------------------------------------------------------------
# K5: weighted Jacobi sweep
# ----------------------------------------------------------------------

def jacobi_sweep(v: torch.Tensor, df: torch.Tensor, lm: int,
                 w: float) -> torch.Tensor:
    """One weighted-Jacobi sweep from v with the hoisted df = dinv * f."""
    _check_lm(lm)
    check_tensor(v, "v", (lm, lm))
    check_tensor(df, "df", (lm, lm), v.dtype)
    out = torch.empty_like(v)
    _call("jacobi_sweep_2d", v.dtype, v.device, v.data_ptr(), df.data_ptr(),
          out.data_ptr(), lm, 1.0 - w, w * 0.25, w, stream(v))
    return out


def jacobi_sweep_ref(v: torch.Tensor, df: torch.Tensor, lm: int,
                     w: float) -> torch.Tensor:
    """Plain version of jacobi_sweep: ((1-w) v + (w/4) s) + w df, s the
    masked neighbour sum inside and 0 on the boundary."""
    interior = box_interior_mask(v.shape, lm, v.device)
    vt = torch.where(interior, v, 0.0)
    s = torch.where(interior, nbr_sum_ref(vt), 0.0)
    return ((1.0 - w) * v + (w * 0.25) * s) + w * df


# ----------------------------------------------------------------------
# K6: red-black Gauss-Seidel sweep
# ----------------------------------------------------------------------

def rb_sweep(v: torch.Tensor, f: torch.Tensor, lm: int) -> torch.Tensor:
    """One full red-black GS sweep: red ((i+j) even) writing every point
    of a new array, then black updating that array in place."""
    _check_lm(lm)
    check_tensor(v, "v", (lm, lm))
    check_tensor(f, "f", (lm, lm), v.dtype)
    out = torch.empty_like(v)
    _call("rb_sweep_2d", v.dtype, v.device, v.data_ptr(), f.data_ptr(),
          out.data_ptr(), lm, stream(v))
    return out


def rb_sweep_ref(v: torch.Tensor, f: torch.Tensor, lm: int) -> torch.Tensor:
    """Plain version of rb_sweep: candidate (f + S(v~)) / 4 inside, f on
    the boundary; red then black on the red result."""
    interior = box_interior_mask(v.shape, lm, v.device)
    i = torch.arange(lm, device=v.device)
    parity = (i.view(-1, 1) + i.view(1, -1)) % 2
    cur = v
    for color in (0, 1):
        vt = torch.where(interior, cur, 0.0)
        cand = torch.where(interior, (f + nbr_sum_ref(vt)) * 0.25, f)
        cur = torch.where(parity == color, cand, cur)
    return cur


# ----------------------------------------------------------------------
# K7: residual
# ----------------------------------------------------------------------

def residual(v: torch.Tensor, f: torch.Tensor, lm: int) -> torch.Tensor:
    """r = f - A v."""
    _check_lm(lm)
    check_tensor(v, "v", (lm, lm))
    check_tensor(f, "f", (lm, lm), v.dtype)
    out = torch.empty_like(v)
    _call("residual_2d", v.dtype, v.device, v.data_ptr(), f.data_ptr(),
          out.data_ptr(), lm, stream(v))
    return out


def residual_ref(v: torch.Tensor, f: torch.Tensor, lm: int) -> torch.Tensor:
    """Plain version of residual: f - where(interior, 4 v~ - S(v~), v)."""
    interior = box_interior_mask(v.shape, lm, v.device)
    vt = torch.where(interior, v, 0.0)
    return f - torch.where(interior, 4.0 * vt - nbr_sum_ref(vt), v)


# ----------------------------------------------------------------------
# K8: masked P^T restriction
# ----------------------------------------------------------------------

def restrict_pt(r: torch.Tensor, lmf: int, lmc: int) -> torch.Tensor:
    """Coarse correction RHS: the fine-interior part of r restricted by
    P^T, zero on the coarse boundary."""
    _check_lm(lmf, lmc)
    _check_levels(lmf, lmc)
    check_tensor(r, "r", (lmf, lmf))
    out = torch.empty((lmc, lmc), dtype=r.dtype, device=r.device)
    _call("restrict_pt_2d", r.dtype, r.device, r.data_ptr(), out.data_ptr(),
          lmf, lmc, stream(r))
    return out


def restrict_pt_ref(r: torch.Tensor, lmf: int, lmc: int) -> torch.Tensor:
    """Plain version of restrict_pt: rows, then columns, then x 1/4."""
    _check_levels(lmf, lmc)
    rt = torch.where(box_interior_mask(r.shape, lmf, r.device), r, 0.0)
    g = combine121(combine121(F.pad(rt, (1, 1, 1, 1)), 0), 1)
    return torch.where(box_interior_mask(g.shape, lmc, r.device),
                       g * 0.25, 0.0)


# ----------------------------------------------------------------------
# K9: bilinear prolongation
# ----------------------------------------------------------------------

def prolong_linear(c: torch.Tensor, lmf: int) -> torch.Tensor:
    """P(c) on the lmf^2 fine box."""
    lmc = c.shape[0]
    _check_lm(lmf, lmc)
    _check_levels(lmf, lmc)
    check_tensor(c, "c", (lmc, lmc))
    out = torch.empty((lmf, lmf), dtype=c.dtype, device=c.device)
    _call("prolong_linear_2d", c.dtype, c.device, c.data_ptr(),
          out.data_ptr(), lmc, lmf, stream(c))
    return out


def prolong_linear_ref(c: torch.Tensor, lmf: int) -> torch.Tensor:
    """Plain version of prolong_linear: columns first, then rows."""
    _check_levels(lmf, c.shape[0])
    return interp_axis(interp_axis(c, 1), 0)
