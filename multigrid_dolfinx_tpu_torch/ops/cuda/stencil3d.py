"""Const-7-point multigrid kernels K1-K3, K10, K11, the P^T restriction
K18 and the red-black half sweep: CUDA wrappers and plain versions.

Each `name(...)` launches the hand-written Hopper kernel of
`csrc/stencil3d.cu` on a CUDA tensor (and raises on anything else); each
`name_ref(...)` is its plain PyTorch version with the same association
order, which the CPU path and the on-card comparison use.  Arrays are the
logical lm^3 node box, contiguous, f32 (f64 is built too).

K1 rb_sweep replaces multigrid_dolfinx_tpu/ops/pallas/stencil3d.py
  rb_sweep_fused: both colours of one red-black sweep in one pass.  Bound
  on the H100: memory, v and f read and out written once (12 bytes a
  point in f32).  Design: one launch a sweep; a block owns a column tile
  of (y, x) points and marches up a z segment, with a ring of v and f
  planes in shared memory filled by asynchronous copies ahead of the
  step, each plane split by the parity of x + y so that one colour's
  points and their neighbours are contiguous.  Step z updates red at
  plane z on the tile grown by 1 in the ring, then black at plane z-2
  from red planes already updated, and writes plane z-3: one barrier a
  step.  Bitwise the two half sweeps (red-black GS is order-free within a
  colour; the same per-point helper, no multiply-add contraction).  Plane
  bases are 64-bit: every lm a card can hold.
rb_half_sweep replaces stencil3d.py rb_half_sweep: one colour of K1 as
  its own entry (rb_color_kernel, one thread per point), out of place.
  Bound: memory, v and f read and out written once in f32.  No solver
  path runs it: K1 does both colours in one launch.
K2 restrict_residual_pt replaces stencil3d.py restrict_residual_pt.
  Bound: memory, 8 bytes per fine point read (v, f) and 4 per coarse
  point written; the residual is never stored.  Design: one thread per
  coarse point recomputes the 27 masked fine residuals around 2I from v
  and f (neighbouring threads share them through L1/L2).
K3 prolong_linear replaces stencil3d.py prolong_linear (v=None) and
  prolong_linear_add (v given: out = v + P(c)).  Bound: memory, 4 bytes
  per fine point written plus 4 read for v; the coarse array is 1/8 of
  that and stays in L2.  Design: one thread per fine point, interpolated
  in x, then y, then z.
K10 residual replaces stencil3d.py residual: r = f - (wc v + woff S(v~))
  inside, f - v on the boundary.  Bound: memory, 8 bytes read (v, f) and
  4 written per point in f32.  Design: one thread per point in 32 x 8
  blocks on x-contiguous rows, 32-bit indices (lm <= MAX_LM).  v and f may
  be the same tensor (the JAX package's A p = p - r(p, p)); the output is
  always a fresh tensor.
K11 jacobi_sweep replaces stencil3d.py jacobi_sweep: (1-w) v + w cand,
  cand = (f + (-woff) S(v~)) / wc inside and f on the boundary, so
  boundary rows mix to (1-w) v + w f.  Bound: memory, as K10.  Design:
  as K10, out of place into a caller-given buffer, so the smoother
  ping-pongs two buffers and never writes the caller's v.
K18 restrict_pt replaces stencil3d.py restrict_pt: the two-step masked
  P^T of a given fine residual (the planes path's restriction).  Bound:
  memory, r read once and the coarse array written once.  Design: K2's
  arithmetic with r read instead of recomputed, one thread per coarse
  point.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from ..operators import box_interior_mask

#: Calls of each wrapper that launched its kernel.  Reset with
#: ops.cuda.reset_launch_counts().
LAUNCHES = {"rb_sweep": 0, "rb_half_sweep": 0, "restrict_residual_pt": 0,
            "prolong_linear": 0, "prolong_linear_add": 0,
            "residual": 0, "jacobi_sweep": 0, "restrict_pt": 0}

#: Largest lm whose lm^3 point index fits the 32-bit ints of K10-K12.
MAX_LM = 1290

_DTYPES = (torch.float32, torch.float64)


def check_tensor(t: torch.Tensor, name: str, shape: Tuple[int, ...],
                 dtype: Optional[torch.dtype] = None) -> None:
    """Raise unless `t` is a contiguous f32/f64 CUDA tensor of `shape`."""
    if not t.is_cuda:
        raise ValueError(f"{name}: the kernel needs a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPES or (dtype is not None and t.dtype != dtype):
        raise TypeError(f"{name}: dtype {t.dtype} not supported here")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def suffix(dtype: torch.dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_pair(lmf: int, lmc: int) -> None:
    """Raise unless the fine box is 2 lmc - 1 points a side."""
    if lmf != 2 * lmc - 1:
        raise ValueError(f"lmf={lmf} is not 2*lmc-1 for lmc={lmc}")


def check_lm(lm: int) -> None:
    """Raise unless lm^3 fits the 32-bit point index of K10-K12."""
    if not 3 <= lm <= MAX_LM:
        raise ValueError(f"lm={lm} outside the kernels' range 3..{MAX_LM} "
                         "(32-bit point indices)")


# ----------------------------------------------------------------------
# K1: red-black Gauss-Seidel sweep
# ----------------------------------------------------------------------

def rb_sweep(v: torch.Tensor, f: torch.Tensor, lm: int, wc: float,
             woff: float) -> torch.Tensor:
    """One full red-black GS sweep of the const-7 operator into a new
    array, red ((x+y+z) even) then black, in one launch."""
    shape = (lm,) * 3
    check_tensor(v, "v", shape)
    check_tensor(f, "f", shape, v.dtype)
    out = torch.empty_like(v)
    fn = getattr(build.library(), f"mg_rb_sweep_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), f.data_ptr(), out.data_ptr(), lm,
                 1.0 / wc, -woff, stream(v))
    build.check(err, "rb_sweep")
    LAUNCHES["rb_sweep"] += 1
    return out


def rb_half_sweep(v: torch.Tensor, f: torch.Tensor, lm: int, wc: float,
                  woff: float, color: int) -> torch.Tensor:
    """One colour of the red-black sweep into a new array: points with
    (x+y+z) % 2 == color take the candidate, the others copy v."""
    if color not in (0, 1):
        raise ValueError(f"color must be 0 (red) or 1 (black), got {color}")
    shape = (lm,) * 3
    check_tensor(v, "v", shape)
    check_tensor(f, "f", shape, v.dtype)
    out = torch.empty_like(v)
    fn = getattr(build.library(), f"mg_rb_half_sweep_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), f.data_ptr(), out.data_ptr(), lm, 1.0 / wc,
                 -woff, color, stream(v))
    build.check(err, "rb_half_sweep")
    LAUNCHES["rb_half_sweep"] += 1
    return out


def nbr_sum_ref(vt: torch.Tensor) -> torch.Tensor:
    """(z-1)+(z+1)+(y-1)+(y+1)+(x-1)+(x+1) of an interior-masked field,
    zero beyond the box."""
    p = F.pad(vt, (1, 1, 1, 1, 1, 1))
    c = slice(1, -1)
    return (((((p[:-2, c, c] + p[2:, c, c]) + p[c, :-2, c]) + p[c, 2:, c])
             + p[c, c, :-2]) + p[c, c, 2:])


def parity_ref(lm: int, device) -> torch.Tensor:
    i = torch.arange(lm, device=device)
    return (i.view(-1, 1, 1) + i.view(1, -1, 1) + i.view(1, 1, -1)) % 2


def rb_half_sweep_ref(v: torch.Tensor, f: torch.Tensor, lm: int, wc: float,
                      woff: float, color: int) -> torch.Tensor:
    """Plain version of rb_half_sweep: candidate (f + (-woff) S) (1/wc)
    inside, f on the boundary, at the points of `color`."""
    interior = box_interior_mask(v.shape, lm, v.device)
    vt = torch.where(interior, v, 0.0)
    cand = torch.where(interior,
                       (f + (-woff) * nbr_sum_ref(vt)) * (1.0 / wc), f)
    return torch.where(parity_ref(lm, v.device) == color, cand, v)


def rb_sweep_ref(v: torch.Tensor, f: torch.Tensor, lm: int, wc: float,
                 woff: float) -> torch.Tensor:
    """Plain version of rb_sweep: the red half sweep ((x+y+z) even), then
    the black one on its result."""
    red = rb_half_sweep_ref(v, f, lm, wc, woff, 0)
    return rb_half_sweep_ref(red, f, lm, wc, woff, 1)


# ----------------------------------------------------------------------
# K2: fused residual + P^T restriction
# ----------------------------------------------------------------------

def restrict_residual_pt(v: torch.Tensor, f: torch.Tensor, lmf: int,
                         lmc: int, wc: float, woff: float) -> torch.Tensor:
    """Coarse RHS mask_c * 0.125 * [1,2,1]^3 (mask_f (f - A v)) sampled at
    even fine indices, without storing the residual."""
    shape = (lmf,) * 3
    check_tensor(v, "v", shape)
    check_tensor(f, "f", shape, v.dtype)
    check_pair(lmf, lmc)
    out = torch.empty((lmc,) * 3, dtype=v.dtype, device=v.device)
    fn = getattr(build.library(), f"mg_restrict_residual_pt_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), f.data_ptr(), out.data_ptr(), lmf, lmc,
                 wc, woff, stream(v))
    build.check(err, "restrict_residual_pt")
    LAUNCHES["restrict_residual_pt"] += 1
    return out


def combine121(x: torch.Tensor, axis: int) -> torch.Tensor:
    """(x[2i-1] + 2 x[2i]) + x[2i+1] along a zero-padded axis."""
    n = x.shape[axis]

    def sl(start, stop):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(start, stop, 2)
        return x[tuple(idx)]

    return (sl(0, n - 2) + 2.0 * sl(1, n - 1)) + sl(2, n)


def restrict_residual_pt_ref(v: torch.Tensor, f: torch.Tensor, lmf: int,
                             lmc: int, wc: float, woff: float) -> torch.Tensor:
    """Plain version of restrict_residual_pt: z, then y, then x."""
    interior = box_interior_mask(v.shape, lmf, v.device)
    vt = torch.where(interior, v, 0.0)
    return restrict_pt_ref(f - (wc * vt + woff * nbr_sum_ref(vt)), lmf, lmc)


# ----------------------------------------------------------------------
# K18: P^T restriction of a given residual
# ----------------------------------------------------------------------

def restrict_pt(r: torch.Tensor, lmf: int, lmc: int) -> torch.Tensor:
    """mask_c * 0.125 * [1,2,1]^3 (mask_f r) sampled at even fine
    indices."""
    check_tensor(r, "r", (lmf,) * 3)
    check_pair(lmf, lmc)
    out = torch.empty((lmc,) * 3, dtype=r.dtype, device=r.device)
    fn = getattr(build.library(), f"mg_restrict_pt_{suffix(r.dtype)}")
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), out.data_ptr(), lmf, lmc, stream(r))
    build.check(err, "restrict_pt")
    LAUNCHES["restrict_pt"] += 1
    return out


def restrict_pt_ref(r: torch.Tensor, lmf: int, lmc: int) -> torch.Tensor:
    """Plain version of restrict_pt: r masked to the fine interior, then
    (lo + 2 mid) + hi along z, then y, then x, times 0.125, the coarse
    boundary zeroed."""
    g = F.pad(torch.where(box_interior_mask(r.shape, lmf, r.device), r, 0.0),
              (1, 1, 1, 1, 1, 1))
    for axis in range(3):
        g = combine121(g, axis)
    if g.shape[0] != lmc:
        raise ValueError(f"lmc={lmc} does not match fine {tuple(r.shape)}")
    return torch.where(box_interior_mask(g.shape, lmc, r.device),
                       g * 0.125, 0.0)


# ----------------------------------------------------------------------
# K3: trilinear prolongation (+ fused correction)
# ----------------------------------------------------------------------

def prolong_linear(c: torch.Tensor, lmf: int,
                   v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P(c) on the lmf^3 fine box, or v + P(c) when v is given."""
    lmc = c.shape[0]
    check_pair(lmf, lmc)
    check_tensor(c, "c", (lmc,) * 3)
    if v is not None:
        check_tensor(v, "v", (lmf,) * 3, c.dtype)
    out = torch.empty((lmf,) * 3, dtype=c.dtype, device=c.device)
    fn = getattr(build.library(), f"mg_prolong_linear_{suffix(c.dtype)}")
    with torch.cuda.device(c.device):
        err = fn(c.data_ptr(), None if v is None else v.data_ptr(),
                 out.data_ptr(), lmc, lmf, stream(c))
    build.check(err, "prolong_linear")
    LAUNCHES["prolong_linear" if v is None else "prolong_linear_add"] += 1
    return out


def interp_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Interleave x with the midpoints 0.5 * (x[j] + x[j+1]) along axis."""
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = 2 * n - 1
    out = torch.empty(shape, dtype=x.dtype, device=x.device)

    def sl(t, start, stop, step=1):
        idx = [slice(None)] * t.ndim
        idx[axis] = slice(start, stop, step)
        return tuple(idx)

    out[sl(out, 0, None, 2)] = x
    out[sl(out, 1, None, 2)] = 0.5 * (x[sl(x, 0, n - 1)] + x[sl(x, 1, n)])
    return out


def prolong_linear_ref(c: torch.Tensor, lmf: int,
                       v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of prolong_linear: x first, then y, then z."""
    e = interp_axis(interp_axis(interp_axis(c, 2), 1), 0)
    if e.shape[0] != lmf:
        raise ValueError(f"lmf={lmf} does not match coarse {tuple(c.shape)}")
    return e if v is None else v + e


# ----------------------------------------------------------------------
# K10: residual
# ----------------------------------------------------------------------

def residual(v: torch.Tensor, f: torch.Tensor, lm: int, wc: float,
             woff: float) -> torch.Tensor:
    """r = f - A v into a fresh tensor; v and f may be the same tensor."""
    check_lm(lm)
    shape = (lm,) * 3
    check_tensor(v, "v", shape)
    check_tensor(f, "f", shape, v.dtype)
    out = torch.empty_like(v)
    fn = getattr(build.library(), f"mg_residual_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), f.data_ptr(), out.data_ptr(), lm, wc, woff,
                 stream(v))
    build.check(err, "residual")
    LAUNCHES["residual"] += 1
    return out


def residual_ref(v: torch.Tensor, f: torch.Tensor, lm: int, wc: float,
                 woff: float) -> torch.Tensor:
    """Plain version of residual: f - where(interior, wc v~ + woff S(v~),
    v)."""
    interior = box_interior_mask(v.shape, lm, v.device)
    vt = torch.where(interior, v, 0.0)
    return f - torch.where(interior, wc * vt + woff * nbr_sum_ref(vt), v)


# ----------------------------------------------------------------------
# K11: weighted Jacobi sweep
# ----------------------------------------------------------------------

def jacobi_sweep(v: torch.Tensor, f: torch.Tensor, lm: int, wc: float,
                 woff: float, w: float,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One weighted-Jacobi sweep from v into `out` (a fresh tensor if
    None); `out` must not be v or f."""
    check_lm(lm)
    shape = (lm,) * 3
    check_tensor(v, "v", shape)
    check_tensor(f, "f", shape, v.dtype)
    if out is None:
        out = torch.empty_like(v)
    check_tensor(out, "out", shape, v.dtype)
    if out.data_ptr() in (v.data_ptr(), f.data_ptr()):
        raise ValueError("jacobi_sweep: out must not alias v or f")
    fn = getattr(build.library(), f"mg_jacobi_sweep_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), f.data_ptr(), out.data_ptr(), lm, 1.0 / wc,
                 -woff, 1.0 - w, w, stream(v))
    build.check(err, "jacobi_sweep")
    LAUNCHES["jacobi_sweep"] += 1
    return out


def jacobi_sweep_ref(v: torch.Tensor, f: torch.Tensor, lm: int, wc: float,
                     woff: float, w: float,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of jacobi_sweep: (1-w) v + w cand, cand the GS
    candidate (f + (-woff) S(v~)) (1/wc) inside and f on the boundary."""
    interior = box_interior_mask(v.shape, lm, v.device)
    vt = torch.where(interior, v, 0.0)
    cand = torch.where(interior,
                       (f + (-woff) * nbr_sum_ref(vt)) * (1.0 / wc), f)
    return torch.add((1.0 - w) * v, w * cand, out=out)
