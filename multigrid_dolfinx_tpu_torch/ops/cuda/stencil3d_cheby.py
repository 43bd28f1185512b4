"""Fused Chebyshev step K12: CUDA wrapper and plain version.

K12 cheby_step replaces multigrid_dolfinx_tpu/ops/pallas/stencil3d_cheby.py
  cheby_step: one step of the momentum form of the Chebyshev recurrence,
  v + a (v - vp) + b D^-1 (f - A v), on the const-7 operator (D^-1 = 1/wc
  inside, 1 on the boundary's identity rows).  Bound on the H100: memory,
  12 bytes read (v, vp, f) and 4 written per point in f32.  Design: one
  thread per point in 32 x 8 blocks on x-contiguous rows, 32-bit indices
  (lm <= stencil3d.MAX_LM), a and b as kernel arguments in the solve's
  dtype (the TPU kernel reads them from SMEM because JAX traces them; here
  the host forms them once per phase, ops.smoothers.chebyshev_phase).
"""
from __future__ import annotations

import torch

from . import build
from .stencil3d import check_lm, check_tensor, residual_ref, stream, suffix
from ..operators import box_interior_mask

LAUNCHES = {"cheby_step": 0}


def cheby_step(v: torch.Tensor, vp: torch.Tensor, f: torch.Tensor, lm: int,
               wc: float, woff: float, a: float, b: float) -> torch.Tensor:
    """(v + a (v - vp)) + b z into a fresh tensor, z = D^-1 (f - A v).
    vp may be v (the phase's first step, a = 0)."""
    check_lm(lm)
    shape = (lm,) * 3
    check_tensor(v, "v", shape)
    check_tensor(vp, "vp", shape, v.dtype)
    check_tensor(f, "f", shape, v.dtype)
    out = torch.empty_like(v)
    fn = getattr(build.library(), f"mg_cheby_step_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), vp.data_ptr(), f.data_ptr(), out.data_ptr(),
                 lm, wc, woff, 1.0 / wc, a, b, stream(v))
    build.check(err, "cheby_step")
    LAUNCHES["cheby_step"] += 1
    return out


def cheby_step_ref(v: torch.Tensor, vp: torch.Tensor, f: torch.Tensor,
                   lm: int, wc: float, woff: float, a: float,
                   b: float) -> torch.Tensor:
    """Plain version of cheby_step: r = f - A v (K10's plain version),
    z = r (1/wc) inside and r on the boundary, then (v + a (v - vp)) +
    b z."""
    interior = box_interior_mask(v.shape, lm, v.device)
    r = residual_ref(v, f, lm, wc, woff)
    z = torch.where(interior, r * (1.0 / wc), r)
    return (v + a * (v - vp)) + b * z
