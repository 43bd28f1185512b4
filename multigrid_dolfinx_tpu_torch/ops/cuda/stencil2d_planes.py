"""Stored-planes 2D kernels K22-K24: CUDA wrappers and plain versions.

The operator is `planes` (K, lm, lm) with K offsets of radius 1 or 2:
row p is sum_k planes[k][p] v[p + off_k] over in-box neighbours (the
variable-coefficient and Galerkin levels of the 2D build_var_hierarchy).
Each `name(...)` launches the hand-written Hopper kernel of
`csrc/stencil2d_planes.cu` on CUDA tensors (and raises on anything else);
each `name_ref(...)` is its plain PyTorch version with the same
association order, which the CPU path and the on-card comparison use.

K22 planes2_residual replaces multigrid_dolfinx_tpu/ops/pallas/stencil2d.py
  planes_residual: r = f - A v.
K23 planes2_jacobi_sweep replaces stencil2d.py planes_jacobi_sweep:
  (1-w) v + w (d f - d sum_{k != c}), d = 1/P_c (1 where P_c = 0).  Out of
  place into a caller-given buffer.
K24 planes2_gs_sweep replaces stencil2d.py planes_gs_sweep: per colour
  of planes2_colors, v + d (f - A v) on the colour's points, in place on
  v; one launch per row class ('quad', 'mod'), each block running the
  class's column residues over its row in turn, or one per colour
  ('sum').
Bound on the H100: memory, (K + 3) arrays per point (K planes, v, f, the
output), 0.80 ms for K = 7 at 8193^2 f32.  Design notes in the CUDA
source.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import build
from .stencil2d import MAX_LM
from .stencil3d import check_tensor, stream, suffix
from ..operators import apply_planes, planes_dinv, stencil_radius

#: Calls of each wrapper that launched its kernel(s) (planes2_gs_sweep is
#: 2 or 3 launches a call).  Reset with ops.cuda.reset_launch_counts().
LAUNCHES = {"planes2_residual": 0, "planes2_jacobi_sweep": 0,
            "planes2_gs_sweep": 0}

#: Most offsets the kernels take: the 5 x 5 box (csrc/stencil2d_planes.cu
#: kMaxOffsets).
MAX_OFFSETS = 25
_KINDS = {"sum": 0, "quad": 1, "mod": 2}


def planes2_colors(offsets) -> Tuple[str, Tuple[int, ...]]:
    """The colour schedule of a 2D planes operator, as the JAX package's
    stencil2d.planes_gs_sweep chooses it: ('mod', range(9)), the per-axis
    residues mod 3, for radius 2; ('sum', (0, 1)), coordinate-sum parity,
    for axis-only radius-1 stencils; ('quad', range(4)), the per-axis
    parity classes, for other radius-1 stencils.  Colour cv packs (py, px)
    in itertools.product order: cv = py m + px."""
    offs = tuple(map(tuple, offsets))
    if stencil_radius(offs) > 1:
        return "mod", tuple(range(9))
    if all(sum(1 for d in off if d != 0) <= 1 for off in offs):
        return "sum", (0, 1)
    return "quad", tuple(range(4))


def colour_mask(kind: str, cv: int, lm: int, device) -> torch.Tensor:
    """Points of colour cv of schedule `kind` on the lm^2 box."""
    i = torch.arange(lm, device=device)
    y, x = i.view(-1, 1), i.view(1, -1)
    if kind == "sum":
        return (y + x) % 2 == cv
    m = 2 if kind == "quad" else 3
    return (y % m == cv // m) & (x % m == cv % m)


@functools.lru_cache(maxsize=None)
def _stencil_args(offsets):
    """(ctypes int array of the flat offsets, K, centre, radius)."""
    import ctypes

    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"{len(offsets)} offsets; the kernels take 1.."
                         f"{MAX_OFFSETS}")
    radius = stencil_radius(offsets)
    if radius not in (1, 2):
        raise ValueError(f"stencil radius {radius}; the kernels take 1 or 2")
    flat = [c for off in offsets for c in off]
    return ((ctypes.c_int * len(flat))(*flat), len(offsets),
            offsets.index((0, 0)), radius)


def _check(v, f, planes, offsets):
    """Check the kernels' inputs; return (lm, offsets as a tuple)."""
    offsets = tuple(map(tuple, offsets))
    lm = v.shape[0]
    if not 3 <= lm <= MAX_LM:
        raise ValueError(f"lm={lm} outside the kernels' range 3..{MAX_LM} "
                         "(32-bit point indices)")
    shape = (lm, lm)
    check_tensor(v, "v", shape)
    check_tensor(f, "f", shape, v.dtype)
    check_tensor(planes, "planes", (len(offsets),) + shape, v.dtype)
    return lm, offsets


def planes2_residual(v: torch.Tensor, f: torch.Tensor, planes: torch.Tensor,
                     offsets) -> torch.Tensor:
    """r = f - A v into a fresh tensor."""
    lm, offsets = _check(v, f, planes, offsets)
    offs, k, center, radius = _stencil_args(offsets)
    out = torch.empty_like(v)
    fn = getattr(build.library(), f"mg_planes2_residual_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), f.data_ptr(), planes.data_ptr(),
                 out.data_ptr(), lm, offs, k, center, radius, stream(v))
    build.check(err, "planes2_residual")
    LAUNCHES["planes2_residual"] += 1
    return out


def planes2_residual_ref(v: torch.Tensor, f: torch.Tensor,
                         planes: torch.Tensor, offsets) -> torch.Tensor:
    """Plain version of planes2_residual."""
    return f - apply_planes(v, planes, tuple(map(tuple, offsets)))


def planes2_jacobi_sweep(v: torch.Tensor, f: torch.Tensor,
                         planes: torch.Tensor, offsets, w: float,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One weighted-Jacobi sweep from v into `out` (a fresh tensor if
    None); `out` must not be v or f."""
    lm, offsets = _check(v, f, planes, offsets)
    offs, k, center, radius = _stencil_args(offsets)
    if out is None:
        out = torch.empty_like(v)
    check_tensor(out, "out", v.shape, v.dtype)
    if out.data_ptr() in (v.data_ptr(), f.data_ptr()):
        raise ValueError("planes2_jacobi_sweep: out must not alias v or f")
    fn = getattr(build.library(), f"mg_planes2_jacobi_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), f.data_ptr(), planes.data_ptr(),
                 out.data_ptr(), lm, offs, k, center, radius, 1.0 - w, w,
                 stream(v))
    build.check(err, "planes2_jacobi_sweep")
    LAUNCHES["planes2_jacobi_sweep"] += 1
    return out


def planes2_jacobi_sweep_ref(v: torch.Tensor, f: torch.Tensor,
                             planes: torch.Tensor, offsets, w: float,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain version of planes2_jacobi_sweep."""
    offsets = tuple(map(tuple, offsets))
    center = offsets.index((0, 0))
    acc = apply_planes(v, planes, offsets, skip=center)
    d = planes_dinv(planes, center)
    return torch.add((1.0 - w) * v, w * (d * f - d * acc), out=out)


def planes2_gs_sweep(v: torch.Tensor, f: torch.Tensor, planes: torch.Tensor,
                     offsets) -> torch.Tensor:
    """One full multicolour Gauss-Seidel sweep in place on v (returned);
    v must not alias f."""
    lm, offsets = _check(v, f, planes, offsets)
    offs, k, center, radius = _stencil_args(offsets)
    kind, _ = planes2_colors(offsets)
    if v.data_ptr() == f.data_ptr():
        raise ValueError("planes2_gs_sweep: v must not alias f")
    fn = getattr(build.library(), f"mg_planes2_gs_sweep_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), f.data_ptr(), planes.data_ptr(), lm, offs,
                 k, center, radius, _KINDS[kind], stream(v))
    build.check(err, "planes2_gs_sweep")
    LAUNCHES["planes2_gs_sweep"] += 1
    return v


def planes2_gs_sweep_ref(v: torch.Tensor, f: torch.Tensor,
                         planes: torch.Tensor, offsets) -> torch.Tensor:
    """Plain version of planes2_gs_sweep: colour by colour, u + d (f - A u)
    on the colour's points, then written into v."""
    offsets = tuple(map(tuple, offsets))
    kind, colours = planes2_colors(offsets)
    d = planes_dinv(planes, offsets.index((0, 0)))
    u = v
    for cv in colours:
        cand = u + d * (f - apply_planes(u, planes, offsets))
        u = torch.where(colour_mask(kind, cv, u.shape[0], u.device), cand, u)
    return v.copy_(u)
