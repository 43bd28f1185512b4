"""The port's variable-coefficient build and solve (build_var_hierarchy,
the V-cycle, FMG, MG-CG on stored planes) against the JAX package's on
the CPU in f64.

Both packages build the same problem, kappa = 1 + x + 2z, 16^3 finest,
coarsest_elements 4 and coarsest_level 1 (as tests/test_fast_var.py), in
four configurations: Galerkin with red-black / Jacobi smoothing,
rediscretised coarse operators, and Galerkin with a reaction term.  The
JAX side is its plain path (use_pallas=False), built and solved once per
module and run op by op under `jax.disable_jit()`: the JAX package's own
functions, without compiling its whole-solve programs, which would take
most of the test clock.  Arrays are held to atol 1e-11; histories to rtol
1e-9 with an absolute floor of 1e-15 ||b||_M (the port's residual follows
the kernels' association, the JAX plain path another).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_dolfinx_tpu as J
from multigrid_dolfinx_tpu.fem import fast_var as jfv
from multigrid_dolfinx_tpu.solver.hierarchy import build_var_hierarchy as jbuild
from multigrid_dolfinx_tpu.solver.krylov import mgcg_solve as jmgcg
import multigrid_dolfinx_tpu_torch as T
from multigrid_dolfinx_tpu_torch.fem import fast_var as tfv
from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm

torch.set_num_threads(1)

ATOL = 1e-11
RTOL = 1e-9
CONFIGS = {
    "galerkin-rbgs": ("galerkin", "rbgs", 0.0),
    "galerkin-jacobi": ("galerkin", "jacobi", 0.0),
    "rediscretize-rbgs": ("rediscretize", "rbgs", 0.0),
    "galerkin-rbgs-reaction": ("galerkin", "rbgs", 5.0),
}


def _kappa(*xs):
    return 1.0 + xs[0] + 2.0 * xs[-1]


def _config(M, name, dtype="float64", **cycle):
    coarse_op, smoother, reaction = CONFIGS[name]
    kw = dict(nu1=2, nu2=2, smoother=smoother, restriction="pt", tol=0.0,
              rtol=1e-8, max_cycles=60, track_error=False)
    kw.update(cycle)
    if M is J:
        kw["use_pallas"] = False
    return M.config.SolverConfig(
        problem=M.config.ProblemSpec(ndim=3, kappa=_kappa, rhs_const=-6.0,
                                     reaction=reaction),
        hierarchy=M.config.HierarchySpec(coarsest_elements=4,
                                         coarsest_level=1, finest_level=2,
                                         coarse_operator=coarse_op),
        cycle=M.config.CycleSpec(**kw), dtype=dtype)


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


def _assert_same_history(tr, jr, th):
    k = int(jr.num_cycles)
    assert tr.num_cycles == k and tr.converged and bool(jr.converged)
    rn_ref = float(check_norm(th, torch.zeros_like(th.finest.b),
                              th.finest.b))
    np.testing.assert_allclose(tr.res_hist[:k].numpy(),
                               np.asarray(jr.res_hist[:k]),
                               rtol=RTOL, atol=1e-15 * rn_ref)
    assert np.isnan(tr.res_hist[k:].numpy()).all()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_var_build_matches_jax(name):
    """Every level's offsets, planes, b, g and dinv (the port stores none:
    the operator's, from its centre plane), the coarse factor and the mass
    tables = the JAX package's build_var_hierarchy."""
    jh, _ = _jax(name, solve=False)
    th = T.build_var_hierarchy(_config(T, name), device="cpu")
    st = _jax_state(jh)
    assert th.num_levels == len(st["levels"]) == 2
    for tl, sl in zip(th.levels, st["levels"]):
        assert tl.A.offsets == sl["offsets"] and tl.n == sl["n"]
        assert tl.sm.dinv is None
        for got, want in ((tl.A.planes, sl["planes"]), (tl.b, sl["b"]),
                          (tl.g, sl["g"]),
                          (tl.A.dinv(torch.float64), sl["dinv"])):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert len(th.finest.A.offsets) == 15
    assert len(th.levels[0].A.offsets) == (
        27 if CONFIGS[name][0] == "galerkin" else 15)
    np.testing.assert_allclose(th.coarse.factor.numpy(),
                               st["coarse"]["factor"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(th.M_fine.class_tables.numpy(),
                               st["class_tables"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["galerkin-rbgs", "galerkin-jacobi",
                                  "rediscretize-rbgs"])
def test_var_solve_matches_jax(name):
    """FMG + tolerance solve to rtol 1e-8: the JAX package's cycle count,
    res_hist to rtol 1e-9 (floor 1e-15 ||b||_M), u to 1e-12.  (The
    reaction term changes the build only; its solve runs the
    galerkin-rbgs code path.)"""
    jh, jr = _jax(name)
    cfg = _config(T, name)
    th = T.build_var_hierarchy(cfg, device="cpu")
    tr = T.solve(th, cfg.cycle)
    _assert_same_history(tr, jr, th)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                               atol=1e-12)


def test_hierarchy_from_numpy_var_gives_same_solve():
    """The JAX var hierarchy carried across as numpy solves like the JAX
    package."""
    jh, jr = _jax("galerkin-rbgs")
    cfg = _config(T, "galerkin-rbgs")
    th = T.hierarchy_from_numpy(_jax_state(jh), cfg, device="cpu")
    for tl, lv in zip(th.levels, jh.levels):
        assert torch.equal(tl.A.planes, torch.from_numpy(
            np.array(lv.A.planes)))
    _assert_same_history(T.solve(th, cfg.cycle), jr, th)


def test_mgcg_on_var_matches_jax():
    """FMG-started MG-CG with the V(2,2) multicolour-GS cycle: the JAX
    package's iteration count and history."""
    jh, _ = _jax("galerkin-rbgs", solve=False)
    jcfg, tcfg = (_config(M, "galerkin-rbgs") for M in (J, T))
    with jax.disable_jit():
        jr = jmgcg(jh, jcfg.cycle)
    th = T.build_var_hierarchy(tcfg, device="cpu")
    tr = T.mgcg_solve(th, tcfg.cycle)
    k = int(jr.num_iters)
    assert tr.num_iters == k and tr.converged and bool(jr.converged)
    rn_ref = float(check_norm(th, torch.zeros_like(th.finest.b),
                              th.finest.b))
    np.testing.assert_allclose(tr.res_hist[:k].numpy(),
                               np.asarray(jr.res_hist[:k]), rtol=1e-8,
                               atol=1e-15 * rn_ref)


def test_galerkin_rap_matches_jax():
    """The RAP convolution on random 15-offset planes at 17^3 -> 9^3 = the
    JAX package's lax.conv (f64, HIGHEST)."""
    offs = tfv.structural_offsets(3, "right")
    planes = np.random.default_rng(5).standard_normal((15,) + (17,) * 3)
    with jax.disable_jit():
        joffs, jout = jfv.galerkin_rap_device(offs, jnp.asarray(planes), 17)
    toffs, tout = tfv.galerkin_rap_device(offs, torch.from_numpy(planes), 17)
    assert toffs == tuple(map(tuple, joffs))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-13,
                               atol=1e-13 * np.abs(np.asarray(jout)).max())


def test_var_f32_solve_takes_the_f64_count():
    """The var slice in f32 on the CPU: the f64 run's cycle count to rtol
    1e-6, the first cycle's residual within 1e-4 (the later ones reach
    the f32 floor)."""
    runs = {}
    for dtype in ("float32", "float64"):
        cfg = _config(T, "galerkin-rbgs", dtype=dtype, rtol=1e-6)
        h = T.build_var_hierarchy(cfg, device="cpu")
        assert h.finest.A.planes.dtype == getattr(torch, dtype)
        runs[dtype] = T.solve(h, cfg.cycle)
    r32, r64 = runs["float32"], runs["float64"]
    assert r32.converged and r32.num_cycles == r64.num_cycles
    np.testing.assert_allclose(float(r32.res_hist[0]),
                               float(r64.res_hist[0]), rtol=1e-4)


def test_chebyshev_on_the_var_build_raises():
    """Chebyshev needs the power-iteration lmax: the var build and a
    planes smoother both raise naming ROADMAP.md queue 1, item 19."""
    cfg = _config(T, "galerkin-rbgs")
    cheb = dataclasses.replace(cfg, cycle=dataclasses.replace(
        cfg.cycle, smoother="chebyshev"))
    with pytest.raises(NotImplementedError, match="item 19"):
        T.build_var_hierarchy(cheb, device="cpu")
    h = T.build_var_hierarchy(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 19"):
        T.solve(h, cheb.cycle)


def test_var_build_checks_its_problem():
    """kappa=None is the lean build's, a callable right-hand side the
    host-assembled build's (ROADMAP item 20); the lean build refuses kappa
    naming build_var_hierarchy; the model constructor matches the JAX
    package's."""
    cfg = _config(T, "galerkin-rbgs")
    with pytest.raises(ValueError, match="build_lean_hierarchy"):
        T.build_var_hierarchy(dataclasses.replace(
            cfg, problem=dataclasses.replace(cfg.problem, kappa=None)),
            device="cpu")
    with pytest.raises(NotImplementedError, match="item 20"):
        T.build_var_hierarchy(dataclasses.replace(
            cfg, problem=T.ProblemSpec(ndim=3, kappa=_kappa, rhs_const=None,
                                       rhs=lambda *xs: -12.0 + 0 * xs[0])),
            device="cpu")
    with pytest.raises(NotImplementedError, match="build_var_hierarchy"):
        T.build_lean_hierarchy(cfg, device="cpu")
    tm = T.models.variable_coefficient_3d(_kappa, dtype="float32")
    jm = J.models.variable_coefficient_3d(_kappa, dtype="float32")
    assert dataclasses.asdict(tm.hierarchy) == dataclasses.asdict(jm.hierarchy)
    assert (tm.problem.rhs_const, tm.problem.ndim, tm.dtype) == (
        jm.problem.rhs_const, jm.problem.ndim, jm.dtype)
    assert (tm.cycle.nu1, tm.cycle.nu2) == (jm.cycle.nu1, jm.cycle.nu2)
