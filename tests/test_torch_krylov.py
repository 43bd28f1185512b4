"""The PyTorch port's MG-CG, Chebyshev, 3D Jacobi and 3D injection paths
(BASELINE.json configurations 3 and 5) against the JAX package (CPU, f64).

Kernels K10 residual, K11 jacobi_sweep and K12 cheby_step (plain
versions) meet the JAX package's plain path (use_pallas=False) on
numpy-seeded inputs to rtol 1e-12 of the output's magnitude: the port
follows the Pallas association order, the JAX plain path another
(v + w Dinv (f - A v) forms, the Chebyshev p-form against the port's
momentum form), so they agree to a few f64 ulps, not bitwise.

The solves run both packages on one lean hierarchy per size (16^3,
32^3; 65^2 in 2D): the same iteration or cycle counts, histories to
rtol 1e-9 with an absolute floor of 1e-15 times the zero iterate's
residual norm, as in tests/test_torch_solve.py (the last entries of a
converged f64 history differ by a few ulps of the terms of f - A v).
MG-CG's dots are torch.sum and jnp.sum, which reduce in other orders.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_dolfinx_tpu as J
import multigrid_dolfinx_tpu_torch as T
from multigrid_dolfinx_tpu.ops.smoothers import chebyshev_smooth as jcheby
from multigrid_dolfinx_tpu.ops.smoothers import jacobi_smooth as jjacobi
from multigrid_dolfinx_tpu.solver.krylov import mgcg_solve as jmgcg
from multigrid_dolfinx_tpu.solver.vcycle import compute_residual as jresidual
from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
from multigrid_dolfinx_tpu_torch.ops import dispatch
from multigrid_dolfinx_tpu_torch.ops.cuda import build, stencil3d
from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_cheby
from multigrid_dolfinx_tpu_torch.ops.smoothers import (CHEBY_EIG_RATIO,
                                                       SmootherData,
                                                       chebyshev_phase, smooth)
from multigrid_dolfinx_tpu_torch.solver import krylov
from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm
from multigrid_dolfinx_tpu_torch.solver.vcycle import compute_residual

torch.set_num_threads(1)

RTOL = 1e-9
KERNEL_RTOL = 1e-12
# (G1) the MG-CG capstone's weak preconditioner, from a zero start
# (scripts/bench_mgcg.py: V(1,1) Jacobi, P^T, rtol 1e-6)
G1 = dict(nu1=1, nu2=1, smoother="jacobi", restriction="pt", tol=0.0,
          rtol=1e-6, max_cycles=60, track_error=False)
# (G2) FMG start, V(2,2) red-black; (C) V(2,2) Chebyshev tolerance solve
G2 = dict(nu1=2, nu2=2, smoother="rbgs", restriction="pt", tol=0.0,
          rtol=1e-8, max_cycles=40, track_error=False)
C = dict(G2, smoother="chebyshev")
INJECTION = dict(nu1=2, nu2=2, smoother="jacobi", restriction="injection",
                 tol=0.0, rtol=0.0, track_error=True)
# The JAX reference solves are compiled at XLA's lowest backend
# optimisation level: the same program at half the compile time.
JAX_COMPILE = {"xla_backend_optimization_level": 0,
               "xla_llvm_disable_expensive_passes": True}

_CACHE = {}


def _cached(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def _configs(ndim, finest_level, cycle):
    jc, tc = J.config.CycleSpec(**cycle), T.CycleSpec(**cycle)
    if ndim == 2:
        return (J.models.poisson2d(finest_level=finest_level, cycle=jc), jc,
                T.models.poisson2d(finest_level=finest_level, cycle=tc), tc)
    shape = dict(finest_level=finest_level, coarsest_level=0,
                 coarsest_elements=8, dtype="float64")
    return (J.models.poisson3d(cycle=jc, **shape), jc,
            T.models.poisson3d(cycle=tc, **shape), tc)


def _hierarchies(ndim, finest_level):
    """The JAX and the port's lean hierarchies of one size, built once.
    Every cycle here keeps omega and cheby_degree at their defaults, so
    one hierarchy serves them all."""
    def run():
        jcfg, _, tcfg, _ = _configs(ndim, finest_level, G2)
        return (J.build_lean_hierarchy(jcfg),
                T.build_lean_hierarchy(tcfg, device="cpu"))
    return _cached(("hier", ndim, finest_level), run)


def _jax_run(fn, jh, **kw):
    run = jax.jit(partial(fn, **kw))
    return run.lower(jh).compile(compiler_options=JAX_COMPILE)(jh)


def _jax_solve(ndim, finest_level, name, cycle, mode="tol"):
    def run():
        jh, _ = _hierarchies(ndim, finest_level)
        spec = J.config.CycleSpec(**cycle)
        return _jax_run(J.fmg_solve, jh, spec=spec, mode=mode)
    return _cached(("solve", ndim, finest_level, name, mode), run)


def _jax_mgcg(finest_level, name, cycle, fmg_start):
    def run():
        jh, _ = _hierarchies(3, finest_level)
        spec = J.config.CycleSpec(**cycle)
        return _jax_run(jmgcg, jh, spec=spec, fmg_start=fmg_start)
    return _cached(("mgcg", finest_level, name), run)


def _rn_ref(th):
    return float(check_norm(th, torch.zeros_like(th.finest.b), th.finest.b))


def _assert_history(t_hist, j_hist, k, th):
    np.testing.assert_allclose(t_hist[:k].numpy(), np.asarray(j_hist[:k]),
                               rtol=RTOL, atol=1e-15 * _rn_ref(th))
    assert np.isnan(t_hist[k:].numpy()).all()


def _close(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=KERNEL_RTOL,
                               atol=KERNEL_RTOL * np.abs(ref).max())


def _inputs(seed, lm, count=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((lm,) * 3) for _ in range(count)]


# ----------------------------------------------------------------------
# K10-K12 plain versions against the JAX plain path
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lidx", [1, 2])
def test_residual_matches_jax(lidx):
    """K10: f - A v = compute_residual (boundary rows f - v)."""
    jh, th = _hierarchies(3, 2)
    lv = jh.levels[lidx]
    lm = lv.n + 1
    v, f = _inputs(70 + lidx, lm)
    wc, woff = dispatch.const7_weights(th.levels[lidx].A)
    ref = jax.jit(lambda vv, ff: jresidual(lv, vv, ff))(jnp.asarray(v),
                                                       jnp.asarray(f))
    port = stencil3d.residual_ref(torch.from_numpy(v), torch.from_numpy(f),
                                  lm, wc, woff)
    _close(port, ref)
    bnd = ~T.ops.operators.box_interior_mask((lm,) * 3, lm).numpy()
    assert np.array_equal(port.numpy()[bnd], (f - v)[bnd])


@pytest.mark.parametrize("lidx", [1, 2])
def test_jacobi_sweep_matches_jax(lidx):
    """K11: one sweep = jacobi_smooth for 1 sweep; boundary rows mix to
    (1-w) v + w f."""
    jh, th = _hierarchies(3, 2)
    lv, tl = jh.levels[lidx], th.levels[lidx]
    lm = lv.n + 1
    v, f = _inputs(80 + lidx, lm)
    w = tl.sm.omega
    wc, woff = dispatch.const7_weights(tl.A)
    ref = jax.jit(lambda vv, ff: jjacobi(lv.sm, vv, ff, 1, A=lv.A))(
        jnp.asarray(v), jnp.asarray(f))
    port = stencil3d.jacobi_sweep_ref(torch.from_numpy(v),
                                      torch.from_numpy(f), lm, wc, woff, w)
    _close(port, ref)
    bnd = ~T.ops.operators.box_interior_mask((lm,) * 3, lm).numpy()
    np.testing.assert_array_equal(port.numpy()[bnd],
                                  ((1.0 - w) * v + w * f)[bnd])


@pytest.mark.parametrize("nsweeps,degree", [(2, 0), (2, 3)])
def test_cheby_phase_matches_jax(nsweeps, degree):
    """The K12 momentum-form phase = chebyshev_smooth (p-form): one
    degree-2 polynomial (cheby_degree=0, nu=2) and 2 rounds of degree 3."""
    jh, th = _hierarchies(3, 2)
    lv, tl = jh.finest, th.finest
    jsm = dataclasses.replace(lv.sm, cheby_degree=degree)
    tsm = dataclasses.replace(tl.sm, cheby_degree=degree)
    assert tsm.lmax == pytest.approx(float(jsm.lmax), rel=1e-15)
    v, f = _inputs(90 + degree, lv.n + 1)
    ref = jax.jit(lambda vv, ff: jcheby(jsm, lv.A, vv, ff, nsweeps))(
        jnp.asarray(v), jnp.asarray(f))
    port = chebyshev_phase(tsm, tl.A, torch.from_numpy(v),
                           torch.from_numpy(f), nsweeps)
    _close(port, ref)


def test_mgcg_operator_keeps_the_smooth_part_in_f32():
    """MG-CG's A p = -r(p, 0) on the smoothest mode at 129^3 in f32 is
    within 1e-3 of the f64 product; the JAX form p - r(p, p), which
    rounds p - A p to f32 first, is at least 4x further off (its error
    grows as h^-3, this one's as h^-2: ~20x apart at 512^3)."""
    cfg = T.models.poisson3d(finest_level=4, coarsest_level=0,
                             coarsest_elements=8, dtype="float64")
    lv = T.build_lean_hierarchy(cfg, device="cpu").finest
    x = torch.linspace(0.0, 1.0, lv.n + 1, dtype=torch.float64)
    s = torch.sin(np.pi * x)
    p64 = s.view(-1, 1, 1) * s.view(1, -1, 1) * s.view(1, 1, -1)
    ref = krylov.apply_operator(lv, p64, torch.zeros_like(p64))
    p32 = p64.float()
    new = krylov.apply_operator(lv, p32, torch.zeros_like(p32)).double()
    jax_form = (p32 - compute_residual(lv, p32, p32)).double()
    scale = float(ref.abs().max())
    err_new = float((new - ref).abs().max()) / scale
    err_jax = float((jax_form - ref).abs().max()) / scale
    assert err_new <= 1e-3
    assert err_jax >= 4 * err_new


def test_jacobi_smoother_keeps_the_callers_v():
    """3D Jacobi ping-pongs two buffers: three sweeps leave v untouched
    and equal three plain sweeps."""
    _, th = _hierarchies(3, 1)
    lv = th.finest
    lm = lv.n + 1
    v, f = (torch.from_numpy(a) for a in _inputs(95, lm))
    v0 = v.clone()
    out = smooth(lv.sm, lv.A, v, f, 3, "jacobi")
    assert torch.equal(v, v0)
    wc, woff = dispatch.const7_weights(lv.A)
    ref = v0
    for _ in range(3):
        ref = stencil3d.jacobi_sweep_ref(ref, f, lm, wc, woff, lv.sm.omega)
    assert torch.equal(out, ref)


# ----------------------------------------------------------------------
# the solves against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("finest_level,iters", [(1, 8), (2, 8)])
def test_mgcg_zero_start_jacobi_matches_jax(finest_level, iters):
    """(G1) zero-start MG-CG with the V(1,1) Jacobi preconditioner to
    rtol 1e-6: 8 iterations at 16^3 and 32^3, as the JAX package."""
    jr = _jax_mgcg(finest_level, "G1", G1, fmg_start=False)
    _, th = _hierarchies(3, finest_level)
    tr = T.solve_mgcg(th, T.CycleSpec(**G1), fmg_start=False)
    assert tr.num_iters == int(jr.num_iters) == iters
    assert tr.converged and bool(jr.converged) and not tr.diverged
    _assert_history(tr.res_hist, jr.res_hist, iters, th)


def test_mgcg_beats_the_plain_loop_with_the_weak_cycle():
    """(G1)'s twin: the plain V(1,1) Jacobi loop from zero takes 20 cycles
    at 16^3 (as the JAX package), MG-CG 8 iterations."""
    jh, th = _hierarchies(3, 1)
    jspec, tspec = J.config.CycleSpec(**G1), T.CycleSpec(**G1)
    jr = _jax_run(lambda h, spec: J.resume_solve(
        h, spec, jnp.zeros_like(h.finest.b)), jh, spec=jspec)
    tr = T.resume_solve(th, tspec, torch.zeros_like(th.finest.b))
    assert tr.num_cycles == int(jr.num_cycles) == 20
    _assert_history(tr.res_hist, jr.res_hist, 20, th)
    cg = T.mgcg_solve(th, tspec, fmg_start=False)
    assert cg.converged and cg.num_iters < tr.num_cycles


def test_mgcg_fmg_start_rbgs_matches_jax():
    """(G2) FMG start + MG-CG with V(2,2) red-black to rtol 1e-8: 2
    iterations at 16^3, as the JAX package."""
    jr = _jax_mgcg(1, "G2", G2, fmg_start=True)
    _, th = _hierarchies(3, 1)
    tr = T.solve_mgcg(th, T.CycleSpec(**G2))
    assert tr.num_iters == int(jr.num_iters) == 2
    assert tr.converged and bool(jr.converged)
    _assert_history(tr.res_hist, jr.res_hist, 2, th)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("finest_level,cycles", [(1, 7), (2, 6)])
def test_chebyshev_solve_matches_jax(finest_level, cycles):
    """(C) FMG + V(2,2) Chebyshev (one degree-2 polynomial per phase) to
    rtol 1e-8: 7 cycles at 16^3 and 6 at 32^3, as the JAX package."""
    jr = _jax_solve(3, finest_level, "C", C)
    _, th = _hierarchies(3, finest_level)
    tr = T.solve(th, T.CycleSpec(**C))
    assert tr.num_cycles == int(jr.num_cycles) == cycles
    assert tr.converged and bool(jr.converged) and not tr.diverged
    _assert_history(tr.res_hist, jr.res_hist, cycles, th)


def test_chebyshev_2d_solve_matches_jax():
    """2D lean V(2,2) Chebyshev (p-form on K7) at 65^2: 4 cycles."""
    jr = _jax_solve(2, 3, "C", C)
    _, th = _hierarchies(2, 3)
    tr = T.solve(th, T.CycleSpec(**C))
    assert tr.num_cycles == int(jr.num_cycles) == 4
    _assert_history(tr.res_hist, jr.res_hist, 4, th)


def test_injection_jacobi_fixed_mode_matches_jax():
    """3D V(2,2) Jacobi with injection (K10's residual, strided copy) in
    fixed mode, mu0 = 2: the final residual and error norms and u.  A
    tolerance solve stalls here in both packages (40 cycles)."""
    jr = _jax_solve(3, 1, "injection", INJECTION, mode="fixed")
    _, th = _hierarchies(3, 1)
    tr = T.fmg_solve(th, T.CycleSpec(**INJECTION), mode="fixed")
    assert tr.num_cycles == int(jr.num_cycles) == 2
    np.testing.assert_allclose(float(tr.res_hist[0]),
                               float(jr.res_hist[0]), rtol=RTOL)
    np.testing.assert_allclose(float(tr.err_hist[0]),
                               float(jr.err_hist[0]), rtol=RTOL)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                               atol=1e-12)


def _jax_state(jh):
    """The JAX hierarchy as numpy arrays."""
    return {
        "levels": [{"b": np.asarray(lv.b), "g": np.asarray(lv.g),
                    "n": lv.n, "offsets": lv.A.offsets,
                    "weights": lv.A.const_weights,
                    "lmax": float(lv.sm.lmax),
                    "dinv": None} for lv in jh.levels],
        "coarse": {"factor": np.asarray(jh.coarse.factor), "piv": None,
                   "kind": jh.coarse.kind},
        "class_tables": np.asarray(jh.M_fine.class_tables),
        "uniform_p1_mass": jh.M_fine.uniform_p1_mass,
    }


def test_hierarchy_from_numpy_chebyshev_solve():
    """The JAX lean Chebyshev hierarchy carried across as numpy gives the
    same Chebyshev solve (7 cycles at 16^3)."""
    jh, th = _hierarchies(3, 1)
    jr = _jax_solve(3, 1, "C", C)
    cfg = _configs(3, 1, C)[2]
    th2 = T.hierarchy_from_numpy(_jax_state(jh), cfg, device="cpu")
    for tl, lv in zip(th2.levels, jh.levels):
        assert tl.sm.cheby_degree == lv.sm.cheby_degree
        assert lv.sm.cheby_eig_ratio == CHEBY_EIG_RATIO
    tr = T.solve(th2, cfg.cycle)
    assert tr.num_cycles == int(jr.num_cycles) == 7
    _assert_history(tr.res_hist, jr.res_hist, 7, th)


# ----------------------------------------------------------------------
# guards, dispatch and wrappers
# ----------------------------------------------------------------------

def test_assembled_chebyshev_build_raises():
    """The assembled build would need the power-iteration lmax."""
    cfg = T.models.poisson2d(cycle=T.CycleSpec(smoother="chebyshev"))
    with pytest.raises(NotImplementedError, match="item 19"):
        T.build_hierarchy(cfg, device="cpu")


def test_builds_default_to_the_card():
    """device defaults to 'cuda': without a card the builds raise and
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _configs(3, 1, G2)[2]
    for build_fn in (T.build_lean_hierarchy, T.build_hierarchy):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_fn(cfg)


def test_dispatch_takes_plain_version_on_cpu():
    """On CPU tensors K10-K12 route to their plain versions and launch
    nothing; the library is never built."""
    lm = 17
    v, vp, f = (torch.from_numpy(a) for a in _inputs(100, lm, 3))
    wc, woff = 0.75, -0.125
    out = torch.empty_like(v)
    kcuda.reset_launch_counts()
    assert torch.equal(dispatch.residual(v, f, lm, wc, woff),
                       stencil3d.residual_ref(v, f, lm, wc, woff))
    assert dispatch.jacobi_sweep(v, f, lm, wc, woff, 0.6, out=out) is out
    assert torch.equal(out, stencil3d.jacobi_sweep_ref(v, f, lm, wc, woff,
                                                       0.6))
    assert torch.equal(
        dispatch.cheby_step(v, vp, f, lm, wc, woff, 0.3, 0.7),
        stencil3d_cheby.cheby_step_ref(v, vp, f, lm, wc, woff, 0.3, 0.7))
    assert all(n == 0 for n in kcuda.launch_counts().values())
    assert build._LIB is None


@pytest.mark.parametrize("kernel", ["residual", "jacobi_sweep",
                                    "cheby_step"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """K10-K12 launch only on CUDA tensors and only for lm <= 1290 (32-bit
    indices); anything else raises before the library is built."""
    v = torch.zeros((17,) * 3, dtype=torch.float32)
    calls = {
        "residual": lambda lm: stencil3d.residual(v, v, lm, 0.75, -0.125),
        "jacobi_sweep": lambda lm: stencil3d.jacobi_sweep(
            v, v, lm, 0.75, -0.125, 0.6),
        "cheby_step": lambda lm: stencil3d_cheby.cheby_step(
            v, v, v, lm, 0.75, -0.125, 0.0, 0.5),
    }
    with pytest.raises(ValueError, match="CUDA tensor"):
        calls[kernel](17)
    with pytest.raises(ValueError, match="32-bit"):
        calls[kernel](stencil3d.MAX_LM + 2)
    assert build._LIB is None


def test_smoother_data_defaults_match_jax():
    """The lean build carries cheby_degree from the config and the window
    ratio 4.0, as the JAX build does."""
    jh, th = _hierarchies(3, 1)
    for tl, lv in zip(th.levels, jh.levels):
        assert isinstance(tl.sm, SmootherData)
        assert tl.sm.cheby_degree == lv.sm.cheby_degree == 0
        assert lv.sm.cheby_eig_ratio == CHEBY_EIG_RATIO == 4.0
        assert tl.sm.lmax == pytest.approx(float(lv.sm.lmax), rel=1e-15)

