"""Fused coarse tail K13/K14: CUDA wrappers and plain versions.

K13 tail_down and K14 tail_up replace multigrid_dolfinx_tpu/ops/pallas/
  stencil3d_tail.py tail_down and tail_up: the levels of a red-black
  V-cycle at and below the tail's top (65^3 in solver.vcycle) as two
  launches instead of about six per level.  tail_down runs the down leg
  (per level, top to 1: nu1 sweeps from zero, then the fused residual +
  P^T restriction), tail_up the up leg after the coarse solve (per level:
  the fused prolongation + correction, then nu2 sweeps).  Bound on the
  H100: launch and barrier latency; the levels hold at most 1.1 MB per
  array in f32.  Design: one cooperative launch per leg with every block
  resident, a grid-wide barrier between steps, grid-strided loops with the
  point arithmetic of K1-K3 (csrc/stencil3d_tail.cu), so each leg agrees
  bitwise with its plain version: the per-level plain K1-K3 sequence.

Levels are given coarsest first, as the JAX package's `levels` tuple:
`lms` = (lm_0, ..., lm_t) and `weights` = ((wc, woff) per level), each
level's box lm^3 unpadded.  tail_down returns (vs, fs), vs = [v_t ..
v_1] and fs = [f_{t-1} .. f_0], the JAX order; tail_up takes the coarse
solution v0, f_t, vs and fs without f_0.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import build
from .stencil3d import (MAX_LM, check_tensor, prolong_linear_ref,
                        rb_sweep_ref, restrict_residual_pt_ref, stream,
                        suffix)

LAUNCHES = {"tail_down": 0, "tail_up": 0}

#: Most levels one tail may hold, the coarsest included (kMaxLevels).
MAX_LEVELS = 8


def check_levels(lms: Sequence[int], weights: Sequence[Tuple[float, float]]
                 ) -> None:
    """Raise unless lms is a 2..MAX_LEVELS chain of halvings lm = 2 lmc - 1
    with one (wc, woff) per level."""
    if not 2 <= len(lms) <= MAX_LEVELS or len(weights) != len(lms):
        raise ValueError(f"a tail holds 2..{MAX_LEVELS} levels with one "
                         f"weight pair each, got {list(lms)}")
    for lmc, lm in zip(lms[:-1], lms[1:]):
        if lm != 2 * lmc - 1 or not 3 <= lmc or lm > MAX_LM:
            raise ValueError(f"levels {list(lms)} are not a chain of "
                             "halvings lm = 2 lmc - 1 within the kernels' "
                             "range")


def _level_args(lms, weights):
    import ctypes

    lm_arr = (ctypes.c_int * len(lms))(*lms)
    w_arr = (ctypes.c_double * (4 * len(lms)))(
        *[x for wc, woff in weights for x in (wc, woff, 1.0 / wc, -woff)])
    return lm_arr, w_arr


def _ptrs(tensors):
    import ctypes

    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def tail_down(f_top: torch.Tensor, lms: Sequence[int],
              weights: Sequence[Tuple[float, float]], nu1: int
              ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The down leg in one launch: (vs, fs) as in the module doc."""
    import ctypes

    check_levels(lms, weights)
    t = len(lms) - 1
    check_tensor(f_top, "f_top", (lms[t],) * 3)
    v = [None] + [torch.empty((lms[l],) * 3, dtype=f_top.dtype,
                              device=f_top.device) for l in range(1, t + 1)]
    f = [torch.empty((lms[l],) * 3, dtype=f_top.dtype, device=f_top.device)
         for l in range(t)]
    v_arr, f_arr = _ptrs(v), _ptrs(f)
    lm_arr, w_arr = _level_args(lms, weights)
    fn = getattr(build.library(), f"mg_tail_down_{suffix(f_top.dtype)}")
    with torch.cuda.device(f_top.device):
        err = fn(f_top.data_ptr(), ctypes.addressof(v_arr),
                 ctypes.addressof(f_arr), ctypes.addressof(lm_arr),
                 ctypes.addressof(w_arr), t, nu1, stream(f_top))
    build.check(err, "tail_down")
    LAUNCHES["tail_down"] += 1
    return v[:0:-1], f[::-1]


def tail_up(v0: torch.Tensor, f_top: torch.Tensor,
            vs: Sequence[torch.Tensor], fs: Sequence[torch.Tensor],
            lms: Sequence[int], weights: Sequence[Tuple[float, float]],
            nu2: int) -> torch.Tensor:
    """The up leg in one launch: the corrected, post-smoothed top level."""
    import ctypes

    check_levels(lms, weights)
    t = len(lms) - 1
    if len(vs) != t or len(fs) != t - 1:
        raise ValueError(f"tail_up needs {t} vs and {t - 1} fs")
    check_tensor(v0, "v0", (lms[0],) * 3)
    check_tensor(f_top, "f_top", (lms[t],) * 3, v0.dtype)
    vd = [None] + list(vs[::-1])
    f = [None] + list(fs[::-1]) + [f_top]
    for l in range(1, t + 1):
        check_tensor(vd[l], f"vs[{t - l}]", (lms[l],) * 3, v0.dtype)
        check_tensor(f[l], f"f level {l}", (lms[l],) * 3, v0.dtype)
    v = [None] + [torch.empty((lms[l],) * 3, dtype=v0.dtype, device=v0.device)
                  for l in range(1, t + 1)]
    vd_arr, f_arr, v_arr = _ptrs(vd), _ptrs(f), _ptrs(v)
    lm_arr, w_arr = _level_args(lms, weights)
    fn = getattr(build.library(), f"mg_tail_up_{suffix(v0.dtype)}")
    with torch.cuda.device(v0.device):
        err = fn(v0.data_ptr(), ctypes.addressof(vd_arr),
                 ctypes.addressof(f_arr), ctypes.addressof(v_arr),
                 ctypes.addressof(lm_arr), ctypes.addressof(w_arr), t, nu2,
                 stream(v0))
    build.check(err, "tail_up")
    LAUNCHES["tail_up"] += 1
    return v[t]


def tail_down_ref(f_top: torch.Tensor, lms: Sequence[int],
                  weights: Sequence[Tuple[float, float]], nu1: int
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Plain version of tail_down: per level, top to 1, nu1 plain K1 sweeps
    from zero and the plain K2 restriction."""
    check_levels(lms, weights)
    vs, fs = [], []
    f = f_top
    for l in range(len(lms) - 1, 0, -1):
        wc, woff = weights[l]
        v = torch.zeros_like(f)
        for _ in range(nu1):
            v = rb_sweep_ref(v, f, lms[l], wc, woff)
        vs.append(v)
        f = restrict_residual_pt_ref(v, f, lms[l], lms[l - 1], wc, woff)
        fs.append(f)
    return vs, fs


def tail_up_ref(v0: torch.Tensor, f_top: torch.Tensor,
                vs: Sequence[torch.Tensor], fs: Sequence[torch.Tensor],
                lms: Sequence[int], weights: Sequence[Tuple[float, float]],
                nu2: int) -> torch.Tensor:
    """Plain version of tail_up: per level, 1 to top, the plain K3
    correction and nu2 plain K1 sweeps."""
    check_levels(lms, weights)
    t = len(lms) - 1
    v = v0
    for l in range(1, t + 1):
        wc, woff = weights[l]
        f = f_top if l == t else fs[t - 1 - l]
        v = prolong_linear_ref(v, lms[l], vs[t - l])
        for _ in range(nu2):
            v = rb_sweep_ref(v, f, lms[l], wc, woff)
    return v
