"""Cycle-step fusion kernels K35-K37: CUDA wrappers and plain versions.

Each `name(...)` launches the hand-written Hopper kernel of
`csrc/stencil3d_cycle.cu` on CUDA tensors (and raises on anything else);
each `name_ref(...)` is its plain PyTorch version, which the CPU path and
the on-card comparison use.  Arrays are the logical lm^3 node box,
contiguous, f32 or f64; the coarse box is lmc^3 with lm = 2 lmc - 1, and
lm <= stencil3d.MAX_LM (32-bit point indices).

K35 rb_sweep2 replaces multigrid_dolfinx_tpu/ops/pallas/stencil3d.py
  rb_sweep2_fused: two red-black sweeps, bitwise K1 after K1.  Bound on
  the H100: memory, v and f read and v written once for both sweeps (K1
  twice moves them twice).  Design: one block of 1024 threads per 16 x 16
  x 32 output tile, v over the tile and a 4-point halo in shared memory,
  the four colour stages on regions shrinking by one point each
  (csrc/stencil3d_cycle.cu).
K36 rb_residual_restrict replaces stencil3d_cycle.py
  rb_residual_restrict_fused: one red-black sweep, then the coarse
  right-hand side P^T (f - A v) of the swept v; bitwise (K1, K2 after
  K1).  Bound: memory, v and f read, v and the coarse array written once.
  Design: K35's window on 8 x 16 x 32 tiles (512 threads); each block
  owns the coarse points whose fine 2I lie in its tile and runs K2's
  restriction on the swept window.
K37 prolong_correct_rb replaces stencil3d_cycle.py
  prolong_correct_rb_fused: v + P(c), then one red-black sweep; bitwise K1
  after K3.  Bound: memory, c, v and f read and v written once.  Design:
  K35's tiles; v + P(c) over the tile and a 2-point halo from the coarse
  footprint in shared memory, then red and black.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .stencil3d import (check_lm, check_pair, check_tensor,
                        prolong_linear_ref, rb_half_sweep_ref, rb_sweep_ref,
                        restrict_residual_pt_ref, stream, suffix)

#: Calls of each wrapper that launched its kernel.  Reset with
#: ops.cuda.reset_launch_counts().
LAUNCHES = {"rb_sweep2": 0, "rb_residual_restrict": 0,
            "prolong_correct_rb": 0}


# ----------------------------------------------------------------------
# K35: two red-black sweeps
# ----------------------------------------------------------------------

def rb_sweep2(v: torch.Tensor, f: torch.Tensor, lm: int, wc: float,
              woff: float) -> torch.Tensor:
    """Two full red-black GS sweeps of the const-7 operator in one launch,
    into a new array."""
    check_lm(lm)
    shape = (lm,) * 3
    check_tensor(v, "v", shape)
    check_tensor(f, "f", shape, v.dtype)
    out = torch.empty_like(v)
    fn = getattr(build.library(), f"mg_rb_sweep2_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), f.data_ptr(), out.data_ptr(), lm, 1.0 / wc,
                 -woff, stream(v))
    build.check(err, "rb_sweep2")
    LAUNCHES["rb_sweep2"] += 1
    return out


def rb_sweep2_ref(v: torch.Tensor, f: torch.Tensor, lm: int, wc: float,
                  woff: float) -> torch.Tensor:
    """Plain version of rb_sweep2: the half sweeps red, black, red,
    black."""
    for color in (0, 1, 0, 1):
        v = rb_half_sweep_ref(v, f, lm, wc, woff, color)
    return v


# ----------------------------------------------------------------------
# K36: red-black sweep + residual + P^T restriction
# ----------------------------------------------------------------------

def rb_residual_restrict(v: torch.Tensor, f: torch.Tensor, lmf: int,
                         lmc: int, wc: float, woff: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v1, fc): v1 one red-black sweep of v, fc = mask_c P^T (mask_f
    (f - A v1)) on the lmc^3 box, in one launch."""
    check_lm(lmf)
    check_pair(lmf, lmc)
    shape = (lmf,) * 3
    check_tensor(v, "v", shape)
    check_tensor(f, "f", shape, v.dtype)
    out = torch.empty_like(v)
    fc = torch.empty((lmc,) * 3, dtype=v.dtype, device=v.device)
    fn = getattr(build.library(), f"mg_rb_residual_restrict_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), f.data_ptr(), out.data_ptr(), fc.data_ptr(),
                 lmf, lmc, wc, woff, 1.0 / wc, -woff, stream(v))
    build.check(err, "rb_residual_restrict")
    LAUNCHES["rb_residual_restrict"] += 1
    return out, fc


def rb_residual_restrict_ref(v: torch.Tensor, f: torch.Tensor, lmf: int,
                             lmc: int, wc: float, woff: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of rb_residual_restrict: rb_sweep_ref, then
    restrict_residual_pt_ref of the swept v."""
    check_pair(lmf, lmc)
    v1 = rb_sweep_ref(v, f, lmf, wc, woff)
    return v1, restrict_residual_pt_ref(v1, f, lmf, lmc, wc, woff)


# ----------------------------------------------------------------------
# K37: prolongation + correction + red-black sweep
# ----------------------------------------------------------------------

def prolong_correct_rb(c: torch.Tensor, v: torch.Tensor, f: torch.Tensor,
                       lmf: int, wc: float, woff: float) -> torch.Tensor:
    """One red-black sweep of v + P(c) in one launch, into a new array."""
    check_lm(lmf)
    lmc = c.shape[0]
    check_pair(lmf, lmc)
    check_tensor(c, "c", (lmc,) * 3)
    check_tensor(v, "v", (lmf,) * 3, c.dtype)
    check_tensor(f, "f", (lmf,) * 3, c.dtype)
    out = torch.empty_like(v)
    fn = getattr(build.library(), f"mg_prolong_correct_rb_{suffix(c.dtype)}")
    with torch.cuda.device(c.device):
        err = fn(c.data_ptr(), v.data_ptr(), f.data_ptr(), out.data_ptr(),
                 lmc, lmf, 1.0 / wc, -woff, stream(c))
    build.check(err, "prolong_correct_rb")
    LAUNCHES["prolong_correct_rb"] += 1
    return out


def prolong_correct_rb_ref(c: torch.Tensor, v: torch.Tensor, f: torch.Tensor,
                           lmf: int, wc: float, woff: float) -> torch.Tensor:
    """Plain version of prolong_correct_rb: prolong_linear_ref(c, lmf, v),
    then rb_sweep_ref."""
    return rb_sweep_ref(prolong_linear_ref(c, lmf, v), f, lmf, wc, woff)
