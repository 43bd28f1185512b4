"""The PyTorch port's 3D lean FMG solve against the JAX package (CPU, f64).

Both packages build the same problem: the port with its own
`build_lean_hierarchy` (and, separately, from the JAX hierarchy's state
through `hierarchy_from_numpy`), the JAX package on its plain path
(use_pallas=False, x64).  They must take the same number of cycles.

Histories are held to rtol 1e-9 with an absolute floor of 1e-15 times the
zero iterate's residual norm: the port's residual and norm follow the
Pallas kernels' association order, the JAX plain path another, and once
the residual has dropped ~1e4 below ||b|| the two f64 evaluations differ
by ~1e-17 absolute (a few ulps of the terms of f - A v), which is up to
~4e-9 of the residual itself.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import multigrid_dolfinx_tpu as J
import multigrid_dolfinx_tpu_torch as T
from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CYCLE = dict(nu1=2, nu2=2, smoother="rbgs", restriction="pt", tol=0.0,
             rtol=1e-8, max_cycles=40, track_error=True)
RTOL = 1e-9
ARRAY_TOL = 1e-13


def _configs(finest_level, **cycle):
    kw = {**CYCLE, **cycle}
    jc, tc = J.config.CycleSpec(**kw), T.CycleSpec(**kw)
    shape = dict(finest_level=finest_level, coarsest_level=0,
                 coarsest_elements=8, dtype="float64")
    return (J.models.poisson3d(cycle=jc, **shape), jc,
            T.models.poisson3d(cycle=tc, **shape), tc)


_JAX_CACHE = {}


def _jax_solve(finest_level):
    """JAX lean hierarchy and tolerance solve, built once per size."""
    if finest_level not in _JAX_CACHE:
        jcfg, jc, _, _ = _configs(finest_level)
        jh = J.build_lean_hierarchy(jcfg)
        _JAX_CACHE[finest_level] = (jh, J.solve(jh, jc))
    return _JAX_CACHE[finest_level]


def _jax_state(jh):
    """The JAX hierarchy as numpy arrays (the jax -> numpy step)."""
    levels = []
    for lv in jh.levels:
        dinv = lv.sm.dinv
        levels.append({"b": np.asarray(lv.b), "g": np.asarray(lv.g),
                       "n": lv.n, "offsets": lv.A.offsets,
                       "weights": lv.A.const_weights,
                       "lmax": float(lv.sm.lmax),
                       "dinv": None if dinv is None else np.asarray(dinv)})
    c = jh.coarse
    return {
        "levels": levels,
        "coarse": {"factor": np.asarray(c.factor),
                   "piv": None if c.piv is None else np.asarray(c.piv),
                   "kind": c.kind},
        "class_tables": np.asarray(jh.M_fine.class_tables),
        "uniform_p1_mass": jh.M_fine.uniform_p1_mass,
    }


def _assert_same_solve(tr, jr, th):
    k = int(jr.num_cycles)
    assert tr.num_cycles == k
    assert tr.converged and bool(jr.converged)
    assert not tr.diverged
    rn_ref = float(check_norm(th, torch.zeros_like(th.finest.b),
                              th.finest.b))
    np.testing.assert_allclose(tr.res_hist[:k].numpy(),
                               np.asarray(jr.res_hist[:k]),
                               rtol=RTOL, atol=1e-15 * rn_ref)
    np.testing.assert_allclose(tr.err_hist[:k].numpy(),
                               np.asarray(jr.err_hist[:k]), rtol=RTOL)
    assert np.isnan(tr.res_hist[k:].numpy()).all()


@pytest.mark.parametrize("finest_level,cycles", [(1, 4), (2, 4)])
def test_solve_matches_jax(finest_level, cycles):
    """16^3 and 32^3: same cycle count (4 and 4), histories to rtol 1e-9."""
    jh, jr = _jax_solve(finest_level)
    _, _, tcfg, tc = _configs(finest_level)
    th = T.build_lean_hierarchy(tcfg, device="cpu")
    tr = T.solve(th, tc)
    assert tr.num_cycles == cycles
    _assert_same_solve(tr, jr, th)


@pytest.mark.parametrize("finest_level", [1, 2])
def test_lean_arrays_match_jax(finest_level):
    """The port's own build gives the JAX package's b, g, weights, lmax,
    coarse factor and mass tables."""
    jh, _ = _jax_solve(finest_level)
    _, _, tcfg, _ = _configs(finest_level)
    th = T.build_lean_hierarchy(tcfg, device="cpu")
    state = _jax_state(jh)
    assert len(th.levels) == len(state["levels"])
    for tl, st in zip(th.levels, state["levels"]):
        assert tl.n == st["n"] and tl.b.shape == st["b"].shape
        np.testing.assert_allclose(tl.b.numpy(), st["b"], rtol=0,
                                   atol=ARRAY_TOL)
        np.testing.assert_allclose(tl.g.numpy(), st["g"], rtol=0,
                                   atol=ARRAY_TOL)
        assert tl.A.offsets == st["offsets"]
        np.testing.assert_allclose(tl.A.const_weights, st["weights"],
                                   rtol=ARRAY_TOL)
        np.testing.assert_allclose(tl.sm.lmax, st["lmax"], rtol=ARRAY_TOL)
    np.testing.assert_allclose(th.coarse.factor.numpy(),
                               state["coarse"]["factor"], rtol=0,
                               atol=ARRAY_TOL)
    np.testing.assert_allclose(th.M_fine.class_tables.numpy(),
                               state["class_tables"], rtol=0, atol=ARRAY_TOL)


def test_operators_match_jax():
    """The const operator's apply and dinv, and the class-table mass
    norm, on the finest level = the JAX package's."""
    jh, _ = _jax_solve(1)
    _, _, tcfg, _ = _configs(1)
    th = T.build_lean_hierarchy(tcfg, device="cpu")
    u = np.random.default_rng(3).standard_normal(th.finest.b.shape)
    ju, tu = jax.numpy.asarray(u), torch.from_numpy(u)
    jA, tA = jh.finest.A, th.finest.A
    np.testing.assert_allclose(tA.apply(tu).numpy(),
                               np.asarray(jax.jit(jA.apply)(ju)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tA.dinv(torch.float64).numpy(),
                               np.asarray(jA.dinv()), rtol=ARRAY_TOL)
    jn = jax.jit(lambda x: J.residual_norm(jh, x))(ju)
    np.testing.assert_allclose(float(T.residual_norm(th, tu)), float(jn),
                               rtol=1e-12)


def test_hierarchy_from_numpy_gives_same_solve():
    """The JAX state carried across as numpy solves like the JAX package."""
    jh, jr = _jax_solve(1)
    _, _, tcfg, tc = _configs(1)
    th = T.hierarchy_from_numpy(_jax_state(jh), tcfg, device="cpu")
    for tl, lv in zip(th.levels, jh.levels):
        assert np.array_equal(tl.b.numpy(), np.asarray(lv.b))
    _assert_same_solve(T.solve(th, tc), jr, th)


def test_fixed_mode_with_debug_matches_jax():
    """mode='fixed' (mu0 cycles on every level) and the finest cycle's
    (restricted residual, coarse error, correction).  The error norm is
    left to the tolerance solves above (it triples the JAX compile)."""
    jcfg, jc, tcfg, tc = _configs(1, track_error=False)
    jh, _ = _jax_solve(1)
    jres, jdbg = jax.jit(lambda h: J.fmg_solve(h, jc, mode="fixed",
                                               collect_debug=True))(jh)
    th = T.build_lean_hierarchy(tcfg, device="cpu")
    tres, tdbg = T.fmg_solve(th, tc, mode="fixed", collect_debug=True)
    assert tres.num_cycles == int(jres.num_cycles) == jc.mu0
    np.testing.assert_allclose(tres.u.numpy(), np.asarray(jres.u),
                               rtol=0, atol=1e-12)
    for t, j in zip(tdbg, jdbg):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-12 * max(np.abs(j).max(), 1.0))
    np.testing.assert_allclose(float(tres.res_hist[0]),
                               float(jres.res_hist[0]), rtol=RTOL)


@pytest.mark.parametrize("kind", ["cholesky", "lu", "inverse"])
def test_coarse_solver_kinds_match_jax(kind):
    """The factorised coarse solve of each kind = the JAX package's."""
    jcfg, _, tcfg, _ = _configs(1, coarse_solver=kind)
    from multigrid_dolfinx_tpu.fem.assembly import assemble_level as jasm
    from multigrid_dolfinx_tpu.mesh import GridLevel as JGrid
    from multigrid_dolfinx_tpu.ops.coarse import build_coarse_solver as jbcs
    from multigrid_dolfinx_tpu_torch.fem.assembly import assemble_level
    from multigrid_dolfinx_tpu_torch.ops.coarse import build_coarse_solver

    a = jasm(JGrid(level=0, ndim=3, n=8), jcfg.problem)
    jsol = jbcs(a.offsets, a.A_planes, kind=kind, dtype=jax.numpy.float64)
    t = assemble_level(T.GridLevel(level=0, ndim=3, n=8), tcfg.problem)
    tsol = build_coarse_solver(t.offsets, t.A_planes, kind=kind,
                               device="cpu")
    f = np.random.default_rng(7).standard_normal((9, 9, 9))
    np.testing.assert_allclose(tsol.solve(torch.from_numpy(f)).numpy(),
                               np.asarray(jsol.solve(jax.numpy.asarray(f))),
                               rtol=0, atol=1e-12)


def test_single_level_is_a_direct_solve():
    """finest == coarsest: the coarse solve alone, zero cycles."""
    jcfg, jc, tcfg, tc = _configs(0)
    jr = J.solve(J.build_lean_hierarchy(jcfg), jc)
    tr = T.solve(T.build_lean_hierarchy(tcfg, device="cpu"), tc)
    assert tr.num_cycles == 0 and tr.converged
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), atol=1e-12)
    assert abs(float(tr.u[4, 4, 4]) - 2.5) < 1e-2


def test_resume_solve_continues_to_tolerance():
    """resume_solve from a numpy iterate runs the tolerance loop on it."""
    _, _, tcfg, tc = _configs(1)
    th = T.build_lean_hierarchy(tcfg, device="cpu")
    first = T.solve(th, tc)
    again = T.resume_solve(th, tc, first.u.numpy())
    assert again.converged and again.num_cycles == 1
    assert float(again.res_hist[0]) < float(first.res_hist[first.num_cycles - 1])


@pytest.mark.parametrize("cycle,match", [
    (dict(cycle="W"), "item 8"),
    (dict(cycle="F"), "item 8"),
    (dict(prolongation="p1"), "item 5"),
])
def test_cycle_options_outside_the_slice_raise(cycle, match):
    _, _, tcfg, tc = _configs(1, **cycle)
    th = T.build_lean_hierarchy(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        T.solve(th, tc)


@pytest.mark.parametrize("problem,match", [
    (dict(ndim=2, degree=2, rhs_const=-6.0), "item 16"),
    (dict(ndim=3, degree=2, rhs_const=-12.0), "item 16"),
    pytest.param(dict(ndim=3, rhs_const=-12.0, kappa=lambda x, y, z: 1.0 + x),
                 "build_var_hierarchy", id="problem2-item 14"),
    (dict(ndim=3, rhs_const=-12.0, reaction=1.0), "item 14"),
])
def test_problems_outside_the_slice_raise(problem, match):
    cfg = T.SolverConfig(problem=T.ProblemSpec(**problem),
                         hierarchy=T.HierarchySpec(coarsest_level=0,
                                                   finest_level=1),
                         cycle=T.CycleSpec(**CYCLE))
    with pytest.raises(NotImplementedError, match=match):
        T.build_lean_hierarchy(cfg, device="cpu")


@pytest.mark.parametrize("n_elems", [16, 96, 512, 768])
def test_factor_levels_matches_jax(n_elems):
    from multigrid_dolfinx_tpu.mesh import factor_levels as jfactor
    from multigrid_dolfinx_tpu_torch.mesh import factor_levels

    assert factor_levels(n_elems) == jfactor(n_elems)


def test_bad_config_values_raise():
    with pytest.raises(ValueError):
        T.CycleSpec(smoother="sor")
    with pytest.raises(ValueError):
        T.HierarchySpec(coarsest_level=2, finest_level=1)
    with pytest.raises(ValueError):
        T.ProblemSpec(diagonal="up")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tcfg, _ = _configs(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.build_lean_hierarchy(tcfg, device="cuda")


def test_port_never_imports_jax():
    """A fresh interpreter importing the port (and running a tiny 3D lean
    solve in f64 and in f32, through the fused tail, a 2D assembled solve,
    MG-CG with 3D Jacobi, a Chebyshev solve, a variable-kappa Galerkin
    solve, a P2 solve and MG-CG, a 2D variable-kappa solve and MG-CG, and
    a one-rank distributed solve over gloo) has no jax in sys.modules.  A subprocess: this test file imports
    jax."""
    code = (
        "import sys, torch\n"
        "import multigrid_dolfinx_tpu_torch as T\n"
        "from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_cheby\n"
        "from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_tail\n"
        "from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_p2\n"
        "from multigrid_dolfinx_tpu_torch.ops.cuda import stencil2d_planes\n"
        "from multigrid_dolfinx_tpu_torch.fem import fast_p2\n"
        "from multigrid_dolfinx_tpu_torch.solver import krylov\n"
        "from multigrid_dolfinx_tpu_torch.utils import convert\n"
        "cyc = T.CycleSpec(nu1=1, nu2=1, smoother='rbgs', restriction='pt',"
        " tol=0.0, rtol=1e-6, max_cycles=5, track_error=False)\n"
        "cfg = T.models.poisson3d(finest_level=1, coarsest_elements=4,"
        " dtype='float64', cycle=cyc)\n"
        "r = T.solve(T.build_lean_hierarchy(cfg, device='cpu'), cyc)\n"
        "assert r.converged\n"
        "c32 = T.models.poisson3d(finest_level=2, coarsest_elements=4,"
        " dtype='float32', cycle=cyc)\n"
        "assert T.solve(T.build_lean_hierarchy(c32, device='cpu'),"
        " cyc).converged\n"
        "cfg2 = T.models.poisson2d(finest_level=1, coarsest_level=0,"
        " coarsest_elements=4, cycle=cyc)\n"
        "r2 = T.solve(T.build_hierarchy(cfg2, device='cpu'), cyc)\n"
        "assert r2.converged and r2.u.shape == (9, 9)\n"
        "for sm in ('jacobi', 'chebyshev'):\n"
        "    c3 = T.CycleSpec(nu1=1, nu2=1, smoother=sm, restriction='pt',"
        " tol=0.0, rtol=1e-6, max_cycles=20, track_error=False)\n"
        "    h3 = T.build_lean_hierarchy(T.models.poisson3d(finest_level=1,"
        " coarsest_elements=4, dtype='float64', cycle=c3), device='cpu')\n"
        "    assert T.solve_mgcg(h3, c3, fmg_start=False).converged, sm\n"
        "    assert T.solve(h3, c3).converged, sm\n"
        "cv = T.models.variable_coefficient_3d(lambda x, y, z: 1.0 + x + 2.0 * y"
        " + z, finest_level=1, coarsest_elements=8, cycle=cyc)\n"
        "rv = T.solve(T.build_var_hierarchy(cv, device='cpu'), cyc)\n"
        "assert rv.converged and rv.u.shape == (17, 17, 17)\n"
        "cp = T.CycleSpec(nu1=2, nu2=2, smoother='jacobi', restriction='pt',"
        " tol=0.0, rtol=1e-8, max_cycles=30, track_error=False)\n"
        "hp = T.build_p2_hierarchy(T.models.poisson3d_p2(finest_level=1,"
        " coarsest_elements=2, dtype='float64', cycle=cp), device='cpu')\n"
        "assert T.solve(hp, cp).converged and T.mgcg_solve(hp, cp).converged\n"
        "c2 = T.models.variable_coefficient_2d(lambda x, y: 1.0 + x + 2.0 * y,"
        " finest_level=1, coarsest_level=0, cycle=cyc)\n"
        "h2 = T.build_var_hierarchy(c2, device='cpu')\n"
        "r2v = T.solve(h2, cyc)\n"
        "assert r2v.converged and r2v.u.shape == (17, 17)\n"
        "assert T.mgcg_solve(h2, cyc).converged\n"
        "import tempfile, torch.distributed as dist\n"
        "from multigrid_dolfinx_tpu_torch.parallel import halo3d\n"
        "from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_dist\n"
        "store = tempfile.mkdtemp()\n"
        "dist.init_process_group('gloo', init_method=f'file://{store}/s',"
        " rank=0, world_size=1)\n"
        "hd, fn = halo3d.build_halo_solver3d(cfg, device='cpu')\n"
        "rd = fn(hd)\n"
        "assert rd.converged and rd.num_cycles == r.num_cycles\n"
        "assert torch.equal(halo3d.gather_solution(hd, rd.u), r.u)\n"
        "dist.destroy_process_group()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('multigrid_dolfinx_tpu.') "
        " or m == 'multigrid_dolfinx_tpu']\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py on a host without CUDA exits nonzero, no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert '"kernels"' not in out.stdout
