"""Dispatch between the CUDA kernels and their plain versions.

The rule is the device of the tensor, and nothing else: a CUDA tensor
goes to the hand-written kernel (which raises if it cannot run), a CPU
tensor to the kernel's plain PyTorch version.  There is no fallback from
a failed build or launch and no switch that sends a CUDA tensor to the
plain version.
"""
from __future__ import annotations

import torch

from .cuda import (stencil2d, stencil3d, stencil3d_cheby, stencil3d_norm,
                   stencil3d_tail)
from .operators import StencilOperator

POISSON5_2D_OFFSETS = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
POISSON5_2D_WEIGHTS = (-1.0, -1.0, 4.0, -1.0, -1.0)
POISSON7_3D_OFFSETS = (
    (-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0),
    (0, 0, 1), (0, 1, 0), (1, 0, 0),
)


def const7_weights(A: StencilOperator):
    """(wc, woff) of an isotropic const-7-point operator, or None."""
    if A.offsets != POISSON7_3D_OFFSETS or A.const_weights is None:
        return None
    w = A.const_weights
    center = A.center_index()
    offs = [w[k] for k in range(7) if k != center]
    if not all(abs(o - offs[0]) < 1e-12 * abs(w[center]) for o in offs):
        return None
    return float(w[center]), float(offs[0])


def const5_ok(A: StencilOperator) -> bool:
    """Is A the 2D const-5 operator the stencil2d kernels hard-code: the
    P1 stiffness (-1, -1, 4, -1, -1), exactly (JAX dispatch.pallas_eligible,
    2D branch)?"""
    return (A.is_const and A.offsets == POISSON5_2D_OFFSETS
            and tuple(A.const_weights) == POISSON5_2D_WEIGHTS)


def require_const5(A: StencilOperator) -> None:
    """Raise for a 2D operator the const-5 kernels and their plain
    versions do not compute, on every device."""
    if not const5_ok(A):
        raise NotImplementedError(
            "2D operators other than the const-5 P1 stencil (variable "
            "kappa, Galerkin, screened) are ROADMAP.md queue 1, item 14")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


def rb_sweep(v, f, lm, wc, woff):
    if _on_cuda(v):
        return stencil3d.rb_sweep(v, f, lm, wc, woff)
    return stencil3d.rb_sweep_ref(v, f, lm, wc, woff)


def restrict_residual_pt(v, f, lmf, lmc, wc, woff):
    if _on_cuda(v):
        return stencil3d.restrict_residual_pt(v, f, lmf, lmc, wc, woff)
    return stencil3d.restrict_residual_pt_ref(v, f, lmf, lmc, wc, woff)


def prolong_linear(c, lmf, v=None):
    if _on_cuda(c):
        return stencil3d.prolong_linear(c, lmf, v)
    return stencil3d.prolong_linear_ref(c, lmf, v)


def residual(v, f, lm, wc, woff):
    if _on_cuda(v):
        return stencil3d.residual(v, f, lm, wc, woff)
    return stencil3d.residual_ref(v, f, lm, wc, woff)


def jacobi_sweep(v, f, lm, wc, woff, w, out=None):
    if _on_cuda(v):
        return stencil3d.jacobi_sweep(v, f, lm, wc, woff, w, out)
    return stencil3d.jacobi_sweep_ref(v, f, lm, wc, woff, w, out)


def cheby_step(v, vp, f, lm, wc, woff, a, b):
    if _on_cuda(v):
        return stencil3d_cheby.cheby_step(v, vp, f, lm, wc, woff, a, b)
    return stencil3d_cheby.cheby_step_ref(v, vp, f, lm, wc, woff, a, b)


def tail_down(f_top, lms, weights, nu1):
    if _on_cuda(f_top):
        return stencil3d_tail.tail_down(f_top, lms, weights, nu1)
    return stencil3d_tail.tail_down_ref(f_top, lms, weights, nu1)


def tail_up(v0, f_top, vs, fs, lms, weights, nu2):
    if _on_cuda(v0):
        return stencil3d_tail.tail_up(v0, f_top, vs, fs, lms, weights, nu2)
    return stencil3d_tail.tail_up_ref(v0, f_top, vs, fs, lms, weights, nu2)


def residual_tet_quad(v, f, lm, wc, woff, diagonal):
    if _on_cuda(v):
        return stencil3d_norm.residual_tet_quad(v, f, lm, wc, woff, diagonal)
    return stencil3d_norm.residual_tet_quad_ref(v, f, lm, wc, woff, diagonal)


def jacobi_sweep_2d(v, df, lm, w):
    if _on_cuda(v):
        return stencil2d.jacobi_sweep(v, df, lm, w)
    return stencil2d.jacobi_sweep_ref(v, df, lm, w)


def rb_sweep_2d(v, f, lm):
    if _on_cuda(v):
        return stencil2d.rb_sweep(v, f, lm)
    return stencil2d.rb_sweep_ref(v, f, lm)


def residual_2d(v, f, lm):
    if _on_cuda(v):
        return stencil2d.residual(v, f, lm)
    return stencil2d.residual_ref(v, f, lm)


def restrict_pt_2d(r, lmf, lmc):
    if _on_cuda(r):
        return stencil2d.restrict_pt(r, lmf, lmc)
    return stencil2d.restrict_pt_ref(r, lmf, lmc)


def prolong_linear_2d(c, lmf):
    if _on_cuda(c):
        return stencil2d.prolong_linear(c, lmf)
    return stencil2d.prolong_linear_ref(c, lmf)
