"""The port's stored-planes kernels K15-K18 (plain versions, CPU, f64)
against the JAX package's plain ops.

K15 planes3_residual, K16 planes3_jacobi_sweep and K17 planes3_gs_sweep
run on random planes with four offset sets: the 15 Kuhn offsets (the
finest variable-kappa level, 8 'coord' colours), the 27 Galerkin offsets
(the 3^3 box of the coarse levels), the 7 axis offsets ('sum' colours)
and a radius-2 set ('coord3' colours).  The planes are random everywhere,
the boundary rows included, so out-of-box neighbours are reached: the
port skips them, the JAX package reads zero padding.  The JAX side is
`use_pallas=False` (the Pallas kernels are pinned to it by the JAX
package's own tests), run op by op under `jax.disable_jit()`, which keeps
the reference's compile time off the test clock.  Tolerances: rtol 1e-12
(the JAX package forms the Jacobi sweep through R_omega = D^-1 (A - D)
planes and P^T as 8 x full weighting, other associations).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_dolfinx_tpu.ops import smoothers as jsm
from multigrid_dolfinx_tpu.ops.operators import StencilOperator as JOp
from multigrid_dolfinx_tpu.ops.pallas import stencil3d as jpallas
from multigrid_dolfinx_tpu.solver import vcycle as jvc
from multigrid_dolfinx_tpu_torch.ops import dispatch
from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d as s3
from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_planes as sp
from multigrid_dolfinx_tpu_torch.ops.operators import StencilOperator
from multigrid_dolfinx_tpu_torch.fem.fast_var import structural_offsets

torch.set_num_threads(1)

LM = 11
RTOL = 1e-12
W = 2.0 / 3.0
AXIS7 = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1),
         (0, 1, 0), (1, 0, 0))
BOX27 = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
              for c in (-1, 0, 1))
# radius 2: every offset with |o|_1 <= 2
RADIUS2 = tuple(o for o in ((a, b, c) for a in range(-2, 3)
                            for b in range(-2, 3) for c in range(-2, 3))
                if sum(map(abs, o)) <= 2)
OFFSET_SETS = {"kuhn15": structural_offsets(3, "right"), "box27": BOX27,
               "axis7": AXIS7, "radius2": RADIUS2}
COLOURS = {"kuhn15": "coord", "box27": "coord", "axis7": "sum",
           "radius2": "coord3"}


def _inputs(name, seed=0):
    """(offsets, planes, v, f) as numpy f64: random planes with a
    dominant centre (so one GS sweep stays bounded), random v and f."""
    offs = OFFSET_SETS[name]
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((len(offs),) + (LM,) * 3)
    c = offs.index((0, 0, 0))
    planes[c] = len(offs) + np.abs(planes[c])
    v, f = rng.standard_normal((2,) + (LM,) * 3)
    return offs, planes, v, f


def _jax_op(offs, planes):
    return JOp(planes=jnp.asarray(planes), offsets=offs, logical_m=LM)


def _jax_smoother(offs, planes):
    """The JAX var build's SmootherData: dinv, and R_omega planes."""
    c = offs.index((0, 0, 0))
    pc = jnp.asarray(planes[c])
    dinv = jnp.where(pc != 0, 1.0 / pc, 1.0)
    r_planes = (jnp.asarray(planes) * dinv[None]).at[c].set(0.0)
    r_omega = JOp(planes=r_planes, offsets=offs, logical_m=LM,
                  boundary_mode="zero")
    return jsm.SmootherData(r_omega=r_omega, dinv=dinv,
                            lmax=jnp.asarray(2.0), omega=W, cheby_degree=0,
                            cheby_eig_ratio=4.0)


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=RTOL,
                               atol=RTOL * np.abs(j).max())


@pytest.mark.parametrize("name", list(OFFSET_SETS))
def test_planes_residual_matches_jax(name):
    """K15's plain version = f - A v of the JAX planes operator."""
    offs, planes, v, f = _inputs(name)
    with jax.disable_jit():
        j = jvc.compute_residual(types.SimpleNamespace(A=_jax_op(offs, planes)),
                                 jnp.asarray(v), jnp.asarray(f))
    t = dispatch.planes3_residual(torch.from_numpy(v), torch.from_numpy(f),
                                  torch.from_numpy(planes), offs)
    _close(t, j)


@pytest.mark.parametrize("name", list(OFFSET_SETS))
def test_planes_jacobi_matches_jax(name):
    """K16's plain version = the JAX package's jacobi_smooth through
    R_omega planes, two sweeps (the second from the first's result)."""
    offs, planes, v, f = _inputs(name, seed=1)
    with jax.disable_jit():
        j = jsm.jacobi_smooth(_jax_smoother(offs, planes), jnp.asarray(v),
                              jnp.asarray(f), 2, A=_jax_op(offs, planes))
    tp, tf = torch.from_numpy(planes), torch.from_numpy(f)
    t = torch.from_numpy(v)
    for _ in range(2):
        t = dispatch.planes3_jacobi_sweep(t, tf, tp, offs, W)
    _close(t, j)


@pytest.mark.parametrize("name", list(OFFSET_SETS))
def test_planes_gs_matches_jax(name):
    """K17's plain version = the JAX package's multicolor_gs_smooth: the
    same colours ('sum', 'coord' or 'coord3', as planes3_colors says) in
    the same order."""
    offs, planes, v, f = _inputs(name, seed=2)
    assert sp.planes3_colors(offs) == jpallas.planes3_colors(offs)
    assert sp.planes3_colors(offs)[0] == COLOURS[name]
    with jax.disable_jit():
        j = jsm.multicolor_gs_smooth(_jax_smoother(offs, planes),
                                     _jax_op(offs, planes), jnp.asarray(v),
                                     jnp.asarray(f), 1)
    tv = torch.from_numpy(v.copy())
    t = dispatch.planes3_gs_sweep(tv, torch.from_numpy(f),
                                  torch.from_numpy(planes), offs)
    assert t is tv                                   # in place, as K17
    _close(t, j)


def test_restrict_pt_matches_jax():
    """K18's plain version = the JAX package's restrict_level('pt'): the
    masked P^T of a given residual, 17^3 -> 9^3; and K2's plain version is
    K18's of the masked residual, bitwise (one association)."""
    rng = np.random.default_rng(3)
    r = rng.standard_normal((17,) * 3)
    fine = types.SimpleNamespace(n=16)
    coarse = types.SimpleNamespace(n=8, shape=(9,) * 3)
    with jax.disable_jit():
        j = jvc.restrict_level(jnp.asarray(r), fine, coarse, "pt")
    t = dispatch.restrict_pt(torch.from_numpy(r), 17, 9)
    _close(t, j)
    v, f = (torch.from_numpy(a) for a in rng.standard_normal((2, 17, 17, 17)))
    wc, woff = 0.5, -1.0 / 12.0
    fused = s3.restrict_residual_pt_ref(v, f, 17, 9, wc, woff)
    two_step = s3.restrict_pt_ref(s3.residual_ref(v, f, 17, wc, woff), 17, 9)
    assert torch.equal(fused, two_step)


def test_planes_operator_matches_jax():
    """StencilOperator in planes mode: apply, diag and dinv as the JAX
    package's; radius, axis_only as its."""
    offs, planes, v, _ = _inputs("box27", seed=4)
    planes[offs.index((0, 0, 0)), 1, 2, 3] = 0.0        # dinv's guard
    jop = _jax_op(offs, planes)
    top = StencilOperator(offsets=offs, logical_m=LM, grid_shape=(LM,) * 3,
                          planes=torch.from_numpy(planes))
    with jax.disable_jit():
        japply = jop.apply(jnp.asarray(v))
    _close(top.apply(torch.from_numpy(v)), japply)
    assert torch.equal(top.diag(), torch.from_numpy(np.array(jop.diag())))
    jd = np.asarray(jop.dinv())
    jd = np.where(np.isinf(jd), 1.0, jd)   # the JAX op divides by zero
    assert np.array_equal(top.dinv(torch.float64).numpy(), jd)
    for name, o in OFFSET_SETS.items():
        t = StencilOperator(offsets=o, logical_m=LM, grid_shape=(LM,) * 3)
        j = JOp(planes=None, offsets=o, logical_m=LM, grid_shape=(LM,) * 3)
        assert (t.radius, t.axis_only) == (j.radius, j.axis_only), name


def test_planes_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers raise on CPU tensors (no fallback), and on
    offsets the kernels do not take; dispatch routes CPU tensors to the
    plain versions."""
    offs, planes, v, f = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                          else a for a in _inputs("kuhn15"))
    with pytest.raises(ValueError, match="CUDA"):
        sp.planes3_residual(v, f, planes, offs)
    with pytest.raises(ValueError, match="CUDA"):
        sp.planes3_jacobi_sweep(v, f, planes, offs, W)
    with pytest.raises(ValueError, match="CUDA"):
        sp.planes3_gs_sweep(v, f, planes, offs)
    with pytest.raises(ValueError, match="CUDA"):
        s3.restrict_pt(torch.zeros((17,) * 3), 17, 9)
    with pytest.raises(ValueError, match="radius 3"):
        sp._stencil_args(((0, 0, 0), (3, 0, 0)))
    with pytest.raises(ValueError, match="offsets"):
        sp._stencil_args(tuple((0, 0, k) for k in range(-1, 65)))
    assert torch.equal(dispatch.planes3_residual(v, f, planes, offs),
                       sp.planes3_residual_ref(v, f, planes, offs))
