"""Dispatch between the CUDA kernels and their plain versions.

The rule is the device of the tensor, and nothing else: a CUDA tensor
goes to the hand-written kernel (which raises if it cannot run), a CPU
tensor to the kernel's plain PyTorch version.  There is no fallback from
a failed build or launch and no switch that sends a CUDA tensor to the
plain version.
"""
from __future__ import annotations

import torch

from .cuda import (coarse_band, stencil2d, stencil2d_dist, stencil2d_planes,
                   stencil3d, stencil3d_cheby, stencil3d_cycle,
                   stencil3d_dist, stencil3d_norm, stencil3d_p2,
                   stencil3d_planes, stencil3d_tail)
from .cuda.stencil3d_planes import planes3_colors  # noqa: F401  (re-export)
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
            "2D operators other than the const-5 P1 stencil run as stored "
            "planes (build_var_hierarchy, kernels K22-K24); constant-"
            "coefficient ones come from the host-assembled planes build, "
            "ROADMAP.md queue 1, item 20")


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


def rb_half_sweep(v, f, lm, wc, woff, color):
    if _on_cuda(v):
        return stencil3d.rb_half_sweep(v, f, lm, wc, woff, color)
    return stencil3d.rb_half_sweep_ref(v, f, lm, wc, woff, color)


def rb_sweep2(v, f, lm, wc, woff):
    if _on_cuda(v):
        return stencil3d_cycle.rb_sweep2(v, f, lm, wc, woff)
    return stencil3d_cycle.rb_sweep2_ref(v, f, lm, wc, woff)


def rb_residual_restrict(v, f, lmf, lmc, wc, woff):
    if _on_cuda(v):
        return stencil3d_cycle.rb_residual_restrict(v, f, lmf, lmc, wc, woff)
    return stencil3d_cycle.rb_residual_restrict_ref(v, f, lmf, lmc, wc, woff)


def prolong_correct_rb(c, v, f, lmf, wc, woff):
    if _on_cuda(c):
        return stencil3d_cycle.prolong_correct_rb(c, v, f, lmf, wc, woff)
    return stencil3d_cycle.prolong_correct_rb_ref(c, v, f, lmf, wc, woff)


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


def restrict_pt(r, lmf, lmc):
    if _on_cuda(r):
        return stencil3d.restrict_pt(r, lmf, lmc)
    return stencil3d.restrict_pt_ref(r, lmf, lmc)


def planes3_residual(v, f, planes, offsets):
    if _on_cuda(v):
        return stencil3d_planes.planes3_residual(v, f, planes, offsets)
    return stencil3d_planes.planes3_residual_ref(v, f, planes, offsets)


def planes3_jacobi_sweep(v, f, planes, offsets, w, out=None):
    if _on_cuda(v):
        return stencil3d_planes.planes3_jacobi_sweep(v, f, planes, offsets, w,
                                                     out)
    return stencil3d_planes.planes3_jacobi_sweep_ref(v, f, planes, offsets, w,
                                                     out)


def planes3_gs_sweep(v, f, planes, offsets):
    if _on_cuda(v):
        return stencil3d_planes.planes3_gs_sweep(v, f, planes, offsets)
    return stencil3d_planes.planes3_gs_sweep_ref(v, f, planes, offsets)


def planes2_residual(v, f, planes, offsets):
    if _on_cuda(v):
        return stencil2d_planes.planes2_residual(v, f, planes, offsets)
    return stencil2d_planes.planes2_residual_ref(v, f, planes, offsets)


def planes2_jacobi_sweep(v, f, planes, offsets, w, out=None):
    if _on_cuda(v):
        return stencil2d_planes.planes2_jacobi_sweep(v, f, planes, offsets, w,
                                                     out)
    return stencil2d_planes.planes2_jacobi_sweep_ref(v, f, planes, offsets, w,
                                                     out)


def planes2_gs_sweep(v, f, planes, offsets):
    if _on_cuda(v):
        return stencil2d_planes.planes2_gs_sweep(v, f, planes, offsets)
    return stencil2d_planes.planes2_gs_sweep_ref(v, f, planes, offsets)


def p2_residual(v, f, tables, offsets):
    if _on_cuda(v):
        return stencil3d_p2.p2_residual(v, f, tables, offsets)
    return stencil3d_p2.p2_residual_ref(v, f, tables, offsets)


def p2_jacobi_sweep(v, f, tables, offsets, w, out=None):
    if _on_cuda(v):
        return stencil3d_p2.p2_jacobi_sweep(v, f, tables, offsets, w, out)
    return stencil3d_p2.p2_jacobi_sweep_ref(v, f, tables, offsets, w, out)


def p2_mass_quad(r, tables, offsets):
    if _on_cuda(r):
        return stencil3d_p2.p2_mass_quad(r, tables, offsets)
    return stencil3d_p2.p2_mass_quad_ref(r, tables, offsets)


def p2_residual_mass_quad(v, f, a_tables, a_offsets, m_tables, m_offsets):
    """q = r^T M r with r = f - A v: K19, then K21 (the JAX package's
    stencil3d_p2.p2_residual_mass_quad)."""
    return p2_mass_quad(p2_residual(v, f, a_tables, a_offsets), m_tables,
                        m_offsets)


def residual_tet_quad(v, f, lm, wc, woff, diagonal):
    if _on_cuda(v):
        return stencil3d_norm.residual_tet_quad(v, f, lm, wc, woff, diagonal)
    return stencil3d_norm.residual_tet_quad_ref(v, f, lm, wc, woff, diagonal)


def mass_quad_admits(M: StencilOperator) -> bool:
    """Does K38 compute r^T M r for this mass operator: 3D class tables of
    shape (K, 27) on radius-1 offsets, the centre among them, in a
    point-symmetric pattern (the JAX kernel's operator conditions,
    stencil3d_norm.py residual_mass_quad; its TPU layout conditions do not
    apply to unpadded storage)?"""
    return (M.class_tables is not None
            and stencil3d_norm.mass_quad_refusal(M.class_tables,
                                                 M.offsets) is None)


def residual_mass_quad(v, f, tables, offsets, lm, wc, woff):
    if _on_cuda(v):
        return stencil3d_norm.residual_mass_quad(v, f, tables, offsets, lm,
                                                 wc, woff)
    return stencil3d_norm.residual_mass_quad_ref(v, f, tables, offsets, lm,
                                                 wc, woff)


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


def rb_sweep_dist(v, f, vlo, vhi, flo, fhi, lm, wc, woff, z_base):
    if _on_cuda(v):
        return stencil3d_dist.rb_sweep_dist(v, f, vlo, vhi, flo, fhi, lm, wc,
                                            woff, z_base)
    return stencil3d_dist.rb_sweep_dist_ref(v, f, vlo, vhi, flo, fhi, lm, wc,
                                            woff, z_base)


def jacobi_sweep_dist(v, f, vlo, vhi, flo, fhi, lm, wc, woff, w, z_base):
    if _on_cuda(v):
        return stencil3d_dist.jacobi_sweep_dist(v, f, vlo, vhi, flo, fhi, lm,
                                                wc, woff, w, z_base)
    return stencil3d_dist.jacobi_sweep_dist_ref(v, f, vlo, vhi, flo, fhi, lm,
                                                wc, woff, w, z_base)


def residual_dist(v, f, vlo, vhi, flo, fhi, lm, wc, woff, z_base):
    if _on_cuda(v):
        return stencil3d_dist.residual_dist(v, f, vlo, vhi, flo, fhi, lm, wc,
                                            woff, z_base)
    return stencil3d_dist.residual_dist_ref(v, f, vlo, vhi, flo, fhi, lm, wc,
                                            woff, z_base)


def restrict_residual_pt_dist(v, f, vlo, vhi, flo, fhi, lmf, lmc, wc, woff,
                              z_base):
    if _on_cuda(v):
        return stencil3d_dist.restrict_residual_pt_dist(
            v, f, vlo, vhi, flo, fhi, lmf, lmc, wc, woff, z_base)
    return stencil3d_dist.restrict_residual_pt_dist_ref(
        v, f, vlo, vhi, flo, fhi, lmf, lmc, wc, woff, z_base)


def prolong_linear_dist(c, chi, lmf, z_base, v=None):
    if _on_cuda(c):
        return stencil3d_dist.prolong_linear_dist(c, chi, lmf, z_base, v)
    return stencil3d_dist.prolong_linear_dist_ref(c, chi, lmf, z_base, v)


def rb_sweep_dist_2d(v, f, vlo, vhi, flo, fhi, lm, row_base):
    if _on_cuda(v):
        return stencil2d_dist.rb_sweep_dist_2d(v, f, vlo, vhi, flo, fhi, lm,
                                               row_base)
    return stencil2d_dist.rb_sweep_dist_2d_ref(v, f, vlo, vhi, flo, fhi, lm,
                                               row_base)


def jacobi_sweep_dist_2d(v, df, vlo, vhi, lm, w, row_base):
    if _on_cuda(v):
        return stencil2d_dist.jacobi_sweep_dist_2d(v, df, vlo, vhi, lm, w,
                                                   row_base)
    return stencil2d_dist.jacobi_sweep_dist_2d_ref(v, df, vlo, vhi, lm, w,
                                                   row_base)


def residual_dist_2d(v, f, vlo, vhi, lm, row_base):
    if _on_cuda(v):
        return stencil2d_dist.residual_dist_2d(v, f, vlo, vhi, lm, row_base)
    return stencil2d_dist.residual_dist_2d_ref(v, f, vlo, vhi, lm, row_base)


def restrict_pt_dist_2d(r, rlo, lmf, lmc, row_base):
    if _on_cuda(r):
        return stencil2d_dist.restrict_pt_dist_2d(r, rlo, lmf, lmc, row_base)
    return stencil2d_dist.restrict_pt_dist_2d_ref(r, rlo, lmf, lmc, row_base)


def prolong_add_dist_2d(c, chi, lmf, row_base, v=None):
    if _on_cuda(c):
        return stencil2d_dist.prolong_add_dist_2d(c, chi, lmf, row_base, v)
    return stencil2d_dist.prolong_add_dist_2d_ref(c, chi, lmf, row_base, v)


def coarse_band_solve(f, band):
    if _on_cuda(f):
        return coarse_band.coarse_band_solve(f, band)
    return coarse_band.coarse_band_solve_ref(f, band)
