"""The port's 2D variable-coefficient slice against the JAX package on the
CPU: the plain versions of the 2D planes kernels K22-K24, the 2D
build_var_hierarchy, its solves and hierarchy_from_numpy.

Kernels: K22 planes2_residual, K23 planes2_jacobi_sweep and K24
planes2_gs_sweep (plain versions, f64) on synthetic Dirichlet-eliminated
planes with four offset sets covering the three colour schedules: the 5
axis offsets ('sum'), the 7 P1 offsets of the triangulated square and
the 9-offset Galerkin box ('quad'), and a radius-2 set ('mod'), against
the JAX package's plain ops to rtol 1e-12 with an absolute floor of
1e-12 (the JAX package forms the Jacobi sweep through R_omega = D^-1
(A - D) planes, another association).  One f32 case pins the TPU
kernel's own colour order: K24's plain version against the Pallas
planes_gs_sweep in interpret mode on a tile-aligned padded copy, to the
2e-5 of tests/test_pallas_kernels.py.

Slice: kappa = 1 + x + 2y (the JAX package's own 2D planes fixture), 65^2
finest, coarsest_elements 8 and coarsest_level 1, in f64: builds equal
to 1e-12 for Galerkin, rediscretised and Galerkin with a reaction term;
red-black (multicolour) and Jacobi tolerance solves and FMG-started
MG-CG with the JAX package's counts, histories to rtol 1e-9 with an
absolute floor of 1e-15 ||b||_M.  The JAX side is its plain path
(use_pallas=False), built and solved once per module and run op by op
under `jax.disable_jit()`, which keeps its compile time off the clock.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_dolfinx_tpu as J
from multigrid_dolfinx_tpu.fem import fast_var as jfv
from multigrid_dolfinx_tpu.ops import smoothers as jsm
from multigrid_dolfinx_tpu.ops.operators import StencilOperator as JOp
from multigrid_dolfinx_tpu.ops.pallas import stencil2d as jpallas
from multigrid_dolfinx_tpu.solver.hierarchy import build_var_hierarchy as jbuild
from multigrid_dolfinx_tpu.solver.krylov import mgcg_solve as jmgcg
import multigrid_dolfinx_tpu_torch as T
from multigrid_dolfinx_tpu_torch.fem import fast_var as tfv
from multigrid_dolfinx_tpu_torch.ops import dispatch
from multigrid_dolfinx_tpu_torch.ops.cuda import build
from multigrid_dolfinx_tpu_torch.ops.cuda import stencil2d_planes as sp
from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm

torch.set_num_threads(1)

LM = 17
W = 2.0 / 3.0
ATOL = 1e-12
RTOL = 1e-9
AXIS5 = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
BOX9 = tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))
RADIUS2 = tuple((a, b) for a in range(-2, 3) for b in range(-2, 3)
                if abs(a) + abs(b) <= 2)
OFFSET_SETS = {"axis5": AXIS5, "p1_7": tfv.structural_offsets(2, "right"),
               "box9": BOX9, "radius2": RADIUS2}
SCHEDULES = {"axis5": "sum", "p1_7": "quad", "box9": "quad",
             "radius2": "mod"}
CONFIGS = {
    "galerkin-rbgs": ("galerkin", "rbgs", 0.0),
    "galerkin-jacobi": ("galerkin", "jacobi", 0.0),
    "rediscretize-rbgs": ("rediscretize", "rbgs", 0.0),
    "galerkin-rbgs-reaction": ("galerkin", "rbgs", 5.0),
}


def _inputs(name, seed, lm=LM, dtype=np.float64):
    """(offsets, planes, v, f) as numpy: random planes with a dominant
    centre, Dirichlet-eliminated as the builds leave them, random v, f."""
    offs = OFFSET_SETS[name]
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((len(offs), lm, lm))
    c = offs.index((0, 0))
    planes[c] = len(offs) + np.abs(planes[c])
    planes = tfv.eliminate_dirichlet_device(
        offs, torch.from_numpy(planes), lm).numpy()
    v, f = rng.standard_normal((2, lm, lm))
    return offs, planes.astype(dtype), v.astype(dtype), f.astype(dtype)


def _jax_smoother(offs, planes):
    """The JAX var build's SmootherData: dinv, and R_omega planes."""
    c = offs.index((0, 0))
    pc = jnp.asarray(planes[c])
    dinv = jnp.where(pc != 0, 1.0 / pc, 1.0)
    r_planes = (jnp.asarray(planes) * dinv[None]).at[c].set(0.0)
    r_omega = JOp(planes=r_planes, offsets=offs, logical_m=LM,
                  boundary_mode="zero")
    return jsm.SmootherData(r_omega=r_omega, dinv=dinv,
                            lmax=jnp.asarray(2.0), omega=W, cheby_degree=0,
                            cheby_eig_ratio=4.0)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                               atol=ATOL)


@pytest.mark.parametrize("name", list(OFFSET_SETS))
def test_planes2_kernels_match_jax(name):
    """K22-K24's plain versions = the JAX package's f - A.apply(v),
    jacobi_smooth (two sweeps, R_omega planes) and multicolor_gs_smooth
    (one sweep, the colours planes2_colors names, in the same order)."""
    offs, planes, v, f = _inputs(name, seed=len(OFFSET_SETS[name]))
    assert sp.planes2_colors(offs)[0] == SCHEDULES[name]
    jop = JOp(planes=jnp.asarray(planes), offsets=offs, logical_m=LM)
    jv, jf = jnp.asarray(v), jnp.asarray(f)
    with jax.disable_jit():
        jr = jf - jop.apply(jv)
        jj = jsm.jacobi_smooth(_jax_smoother(offs, planes), jv, jf, 2, A=jop)
        jg = jsm.multicolor_gs_smooth(_jax_smoother(offs, planes), jop, jv,
                                      jf, 1)
    tp, tv, tf = (torch.from_numpy(a) for a in (planes, v, f))
    _close(dispatch.planes2_residual(tv, tf, tp, offs), jr)
    tj = tv
    for _ in range(2):
        tj = dispatch.planes2_jacobi_sweep(tj, tf, tp, offs, W)
    _close(tj, jj)
    tg = tv.clone()
    assert dispatch.planes2_gs_sweep(tg, tf, tp, offs) is tg   # in place
    _close(tg, jg)


def test_planes2_gs_matches_the_pallas_kernel():
    """K24's plain version = the TPU kernel's own sweep
    (stencil2d.planes_gs_sweep, interpret mode) on the 7 P1 offsets in
    f32, the logical 17^2 box padded to a (32, 128) tile-aligned layout
    with zero planes, then cropped."""
    offs, planes, v, f = _inputs("p1_7", seed=11, dtype=np.float32)
    pad = np.zeros((len(offs), 32, 128), np.float32)
    pad[:, :LM, :LM] = planes
    pv, pf = np.zeros((2, 32, 128), np.float32)
    pv[:LM, :LM], pf[:LM, :LM] = v, f
    j = jpallas.planes_gs_sweep(jnp.asarray(pv), jnp.asarray(pf),
                                jnp.asarray(pad), offs, axis_only=False,
                                interpret=True)
    t = sp.planes2_gs_sweep_ref(torch.from_numpy(v), torch.from_numpy(f),
                                torch.from_numpy(planes), offs)
    np.testing.assert_allclose(t.numpy(), np.asarray(j)[:LM, :LM],
                               rtol=2e-5, atol=2e-5)


def _kappa(x, y):
    return 1.0 + x + 2.0 * y


def _config(M, name):
    coarse_op, smoother, reaction = CONFIGS[name]
    kw = dict(nu1=2, nu2=2, smoother=smoother, restriction="pt", tol=0.0,
              rtol=1e-8, max_cycles=60, track_error=False)
    if M is J:
        kw["use_pallas"] = False
    return M.config.SolverConfig(
        problem=M.config.ProblemSpec(ndim=2, kappa=_kappa, rhs_const=-6.0,
                                     reaction=reaction),
        hierarchy=M.config.HierarchySpec(coarsest_elements=8,
                                         coarsest_level=1, finest_level=3,
                                         coarse_operator=coarse_op),
        cycle=M.config.CycleSpec(**kw), dtype="float64")


_JAX_CACHE = {}


def _jax(name, solve=True):
    """The JAX var hierarchy and (solve=True) its tolerance solve, each
    once per config."""
    cfg = _config(J, name)
    if name not in _JAX_CACHE:
        with jax.disable_jit():
            _JAX_CACHE[name] = [jbuild(cfg), None]
    entry = _JAX_CACHE[name]
    if solve and entry[1] is None:
        with jax.disable_jit():
            entry[1] = J.solve(entry[0], cfg.cycle)
    return entry


def _jax_state(jh):
    """The JAX var hierarchy as numpy arrays (the jax -> numpy step)."""
    c = jh.coarse
    return {
        "levels": [{"b": np.asarray(lv.b), "g": np.asarray(lv.g),
                    "n": lv.n, "offsets": tuple(map(tuple, lv.A.offsets)),
                    "planes": np.asarray(lv.A.planes),
                    "dinv": np.asarray(lv.sm.dinv),
                    "lmax": float(lv.sm.lmax)} for lv in jh.levels],
        "coarse": {"factor": np.asarray(c.factor),
                   "piv": None if c.piv is None else np.asarray(c.piv),
                   "kind": c.kind},
        "class_tables": np.asarray(jh.M_fine.class_tables),
        "uniform_p1_mass": jh.M_fine.uniform_p1_mass,
    }


def _assert_same_history(tr, jr, th, count_attr="num_cycles"):
    k = int(getattr(jr, count_attr))
    assert getattr(tr, count_attr) == k and tr.converged and bool(
        jr.converged)
    rn_ref = float(check_norm(th, torch.zeros_like(th.finest.b),
                              th.finest.b))
    np.testing.assert_allclose(tr.res_hist[:k].numpy(),
                               np.asarray(jr.res_hist[:k]),
                               rtol=RTOL, atol=1e-15 * rn_ref)
    assert np.isnan(tr.res_hist[k:].numpy()).all()


@pytest.mark.parametrize("name", ["galerkin-rbgs", "rediscretize-rbgs",
                                  "galerkin-rbgs-reaction"])
def test_var2d_build_matches_jax(name):
    """Every level's offsets, planes, b, g and dinv (the operator's, from
    its centre plane), the coarse factor and the mass tables = the JAX
    package's 2D build_var_hierarchy."""
    jh, _ = _jax(name, solve=False)
    th = T.build_var_hierarchy(_config(T, name), device="cpu")
    st = _jax_state(jh)
    assert th.num_levels == len(st["levels"]) == 3
    for tl, sl in zip(th.levels, st["levels"]):
        assert tl.A.offsets == sl["offsets"] and tl.n == sl["n"]
        for got, want in ((tl.A.planes, sl["planes"]), (tl.b, sl["b"]),
                          (tl.g, sl["g"]),
                          (tl.A.dinv(torch.float64), sl["dinv"])):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert len(th.finest.A.offsets) == 7
    assert len(th.levels[0].A.offsets) == (
        9 if CONFIGS[name][0] == "galerkin" else 7)
    np.testing.assert_allclose(th.coarse.factor.numpy(),
                               st["coarse"]["factor"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(th.M_fine.class_tables.numpy(),
                               st["class_tables"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["galerkin-rbgs", "galerkin-jacobi"])
def test_var2d_solve_matches_jax(name):
    """FMG + tolerance solve to rtol 1e-8 ('quad' multicolour GS, K24's
    plain version, or Jacobi, K23's): the JAX package's cycle count,
    res_hist to rtol 1e-9 (floor 1e-15 ||b||_M), u to 1e-12."""
    jh, jr = _jax(name)
    cfg = _config(T, name)
    th = T.build_var_hierarchy(cfg, device="cpu")
    tr = T.solve(th, cfg.cycle)
    _assert_same_history(tr, jr, th)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                               atol=1e-12)


def test_mgcg_on_var2d_matches_jax():
    """FMG-started MG-CG with the V(2,2) multicolour-GS cycle, A p through
    K22's plain version: the JAX package's iteration count and history."""
    jh, _ = _jax("galerkin-rbgs", solve=False)
    jcfg, tcfg = (_config(M, "galerkin-rbgs") for M in (J, T))
    with jax.disable_jit():
        jr = jmgcg(jh, jcfg.cycle)
    th = T.build_var_hierarchy(tcfg, device="cpu")
    _assert_same_history(T.mgcg_solve(th, tcfg.cycle), jr, th, "num_iters")


def test_hierarchy_from_numpy_var2d_gives_same_solve():
    """The JAX 2D var hierarchy carried across as numpy solves like the
    JAX package."""
    jh, jr = _jax("galerkin-rbgs")
    cfg = _config(T, "galerkin-rbgs")
    th = T.hierarchy_from_numpy(_jax_state(jh), cfg, device="cpu")
    for tl, lv in zip(th.levels, jh.levels):
        assert torch.equal(tl.A.planes, torch.from_numpy(
            np.array(lv.A.planes)))
    _assert_same_history(T.solve(th, cfg.cycle), jr, th)


def test_galerkin_rap_2d_matches_jax():
    """The 2D RAP convolution on random 7-offset planes at 33^2 -> 17^2 =
    the JAX package's lax.conv (f64, HIGHEST)."""
    offs = tfv.structural_offsets(2, "right")
    planes = np.random.default_rng(5).standard_normal((7, 33, 33))
    with jax.disable_jit():
        joffs, jout = jfv.galerkin_rap_device(offs, jnp.asarray(planes), 33)
    toffs, tout = tfv.galerkin_rap_device(offs, torch.from_numpy(planes), 33)
    assert toffs == tuple(map(tuple, joffs)) == BOX9
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-13,
                               atol=1e-13 * np.abs(np.asarray(jout)).max())


def test_var2d_refusals_that_stay():
    """A callable right-hand side needs the host-assembled build (ROADMAP
    item 20), Chebyshev on planes the power-iteration lmax (item 19); the
    model constructor matches the JAX package's."""
    cfg = _config(T, "galerkin-rbgs")
    with pytest.raises(NotImplementedError, match="item 20"):
        T.build_var_hierarchy(dataclasses.replace(
            cfg, problem=dataclasses.replace(
                cfg.problem, rhs_const=None, rhs=lambda x, y: -6.0 + 0 * x)),
            device="cpu")
    cheb = dataclasses.replace(cfg, cycle=dataclasses.replace(
        cfg.cycle, smoother="chebyshev"))
    with pytest.raises(NotImplementedError, match="item 19"):
        T.build_var_hierarchy(cheb, device="cpu")
    h = T.build_var_hierarchy(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 19"):
        T.solve(h, cheb.cycle)
    tm = T.models.variable_coefficient_2d(_kappa)
    jm = J.models.variable_coefficient_2d(_kappa)
    assert dataclasses.asdict(tm.hierarchy) == dataclasses.asdict(jm.hierarchy)
    assert (tm.problem.rhs_const, tm.problem.ndim, tm.dtype) == (
        jm.problem.rhs_const, jm.problem.ndim, jm.dtype)
    assert (tm.cycle.nu1, tm.cycle.nu2, tm.cycle.smoother,
            tm.cycle.restriction) == (jm.cycle.nu1, jm.cycle.nu2,
                                      jm.cycle.smoother, jm.cycle.restriction)


def test_planes2_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers raise on CPU tensors (no fallback) before any
    build, and on offsets the kernels do not take; dispatch routes CPU
    tensors to the plain versions; the const-5 guard points at the planes
    path."""
    offs, planes, v, f = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                          else a for a in _inputs("p1_7", seed=3))
    for call in (lambda: sp.planes2_residual(v, f, planes, offs),
                 lambda: sp.planes2_jacobi_sweep(v, f, planes, offs, W),
                 lambda: sp.planes2_gs_sweep(v, f, planes, offs)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert build._LIB is None
    with pytest.raises(ValueError, match="radius 3"):
        sp._stencil_args(((0, 0), (3, 0)))
    with pytest.raises(ValueError, match="offsets"):
        sp._stencil_args(tuple((0, k) for k in range(-13, 14)))
    assert torch.equal(dispatch.planes2_residual(v, f, planes, offs),
                       sp.planes2_residual_ref(v, f, planes, offs))
    lv = T.build_var_hierarchy(_config(T, "galerkin-rbgs"),
                               device="cpu").finest
    const = dataclasses.replace(lv.A, planes=None, const_weights=(1.0,) * 7)
    with pytest.raises(NotImplementedError, match="K22-K24"):
        dispatch.require_const5(const)
