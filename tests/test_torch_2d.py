"""The PyTorch port's 2D P1 path against the JAX package (CPU).

Kernels K5-K9 (plain versions) meet the JAX package's Pallas kernels,
run in interpret mode as tests/test_pallas_kernels.py runs them, in f32
at lm = 65 in (128, 128) zero-padded JAX storage, cropped to the box.
K6-K9 agree bitwise.  K5 agrees to 4 f32 ulps of the output's magnitude:
XLA's CPU compiler contracts the Pallas body's two multiply-adds,
(1-w) v + (w/4) s and + w df, into FMAs, while the port's plain version
(and its CUDA kernel, built with --fmad=false) rounds each product.

The solves run in f64: the reference's exact run (models.poisson2d(),
assembled build_hierarchy, FMG + V(50,50) weighted Jacobi, injection,
tol 1e-11) and the lean V(2,2) red-black / P^T solve.  Histories are held
to rtol 1e-9 with an absolute floor (1e-13 for the reference run, the
JAX package's own HIST_ATOL in tests/test_reference_parity.py; 1e-15 of
the zero iterate's residual norm for the lean solves, as in
tests/test_torch_solve.py): the port's residual follows the Pallas
association order, the JAX plain path another, which moves the last
residuals of a converged history by a few ulps of the terms of f - A v.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_dolfinx_tpu as J
import multigrid_dolfinx_tpu_torch as T
from multigrid_dolfinx_tpu.ops import transfer as jtransfer
from multigrid_dolfinx_tpu.ops.pallas import stencil2d as jpallas
from multigrid_dolfinx_tpu.utils import csv_io as jcsv
from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
from multigrid_dolfinx_tpu_torch.ops import dispatch, transfer
from multigrid_dolfinx_tpu_torch.ops.cuda import build, stencil2d
from multigrid_dolfinx_tpu_torch.ops.smoothers import smooth
from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm
from multigrid_dolfinx_tpu_torch.utils import csv_io

torch.set_num_threads(1)

RTOL = 1e-9
HIST_ATOL = 1e-13
ARRAY_TOL = 1e-13
LEAN_CYCLE = dict(nu1=2, nu2=2, smoother="rbgs", restriction="pt", tol=0.0,
                  rtol=1e-8, max_cycles=40, track_error=False)

# The JAX reference solves are compiled at XLA's lowest backend
# optimisation level: the same program at half the compile time, which
# dominates these small solves on the CPU.
JAX_COMPILE = {"xla_backend_optimization_level": 0,
               "xla_llvm_disable_expensive_passes": True}

_JAX_CACHE = {}


def _cached(key, fn):
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = fn()
    return _JAX_CACHE[key]


def _jax_solve(jh, spec, mode="tol"):
    """The JAX package's FMG solve (J.solve without its TPU size guard)."""
    run = jax.jit(partial(J.fmg_solve, spec=spec, mode=mode))
    return run.lower(jh).compile(compiler_options=JAX_COMPILE)(jh)


def _reference():
    """The reference's exact run in the JAX package: hierarchy and
    tolerance solve, built once per module."""
    def run():
        cfg = J.models.poisson2d()
        jh = J.build_hierarchy(cfg)
        return jh, _jax_solve(jh, cfg.cycle)
    return _cached("reference", run)


def _lean_configs(finest_level):
    jc, tc = J.config.CycleSpec(**LEAN_CYCLE), T.CycleSpec(**LEAN_CYCLE)
    return (J.models.poisson2d(finest_level=finest_level, cycle=jc), jc,
            T.models.poisson2d(finest_level=finest_level, cycle=tc), tc)


def _lean(finest_level):
    """JAX lean hierarchy and V(2,2) tolerance solve, once per size."""
    def run():
        jcfg, jc, _, _ = _lean_configs(finest_level)
        jh = J.build_lean_hierarchy(jcfg)
        return jh, _jax_solve(jh, jc)
    return _cached(("lean", finest_level), run)


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


def _assert_histories(tr, jr, atol, errors=True):
    k = int(jr.num_cycles)
    assert tr.num_cycles == k
    assert tr.converged and bool(jr.converged) and not tr.diverged
    np.testing.assert_allclose(tr.res_hist[:k].numpy(),
                               np.asarray(jr.res_hist[:k]), rtol=RTOL,
                               atol=atol)
    if errors:
        np.testing.assert_allclose(tr.err_hist[:k].numpy(),
                                   np.asarray(jr.err_hist[:k]), rtol=RTOL,
                                   atol=atol)
    assert np.isnan(tr.res_hist[k:].numpy()).all()


# ----------------------------------------------------------------------
# (a) K5-K9 plain versions against the Pallas kernels (interpret mode)
# ----------------------------------------------------------------------

LM, LMC, W = 65, 33, 128
OMEGA = 2.0 / 3.0


def _padded(a):
    out = np.zeros((W, W), np.float32)
    out[:a.shape[0], :a.shape[1]] = a
    return jnp.asarray(out)


KERNEL_CASES = {
    "jacobi_sweep": (
        lambda v, f, c: jpallas.jacobi_sweep(_padded(v), _padded(f), LM,
                                             OMEGA, interpret=True)[:LM, :LM],
        lambda v, f, c: stencil2d.jacobi_sweep_ref(v, f, LM, OMEGA)),
    "rb_sweep": (
        lambda v, f, c: jpallas.rb_sweep(_padded(v), _padded(f), LM,
                                         interpret=True)[:LM, :LM],
        lambda v, f, c: stencil2d.rb_sweep_ref(v, f, LM)),
    "residual": (
        lambda v, f, c: jpallas.residual(_padded(v), _padded(f), LM,
                                         interpret=True)[:LM, :LM],
        lambda v, f, c: stencil2d.residual_ref(v, f, LM)),
    "restrict_pt": (
        lambda v, f, c: jpallas.restrict_pt(_padded(v), (W, W), LM, LMC,
                                            interpret=True)[:LMC, :LMC],
        lambda v, f, c: stencil2d.restrict_pt_ref(v, LM, LMC)),
    "prolong_linear": (
        lambda v, f, c: jpallas.prolong_linear(_padded(c), (W, W), LM,
                                               interpret=True)[:LM, :LM],
        lambda v, f, c: stencil2d.prolong_linear_ref(c, LM)),
}


@pytest.mark.parametrize("kernel", sorted(KERNEL_CASES))
def test_plain_kernels_match_pallas(kernel):
    """K5-K9 plain versions = the Pallas kernels on the same f32 inputs."""
    rng = np.random.default_rng(sorted(KERNEL_CASES).index(kernel))
    v, f, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((LM, LM), (LM, LM), (LMC, LMC)))
    pallas, plain = KERNEL_CASES[kernel]
    ref = np.asarray(pallas(v, f, c))
    port = plain(*map(torch.from_numpy, (v, f, c))).numpy()
    assert port.dtype == ref.dtype == np.float32
    if kernel == "jacobi_sweep":
        atol = 4 * np.finfo(np.float32).eps * np.abs(ref).max()
        np.testing.assert_allclose(port, ref, rtol=0, atol=atol)
    else:
        assert np.array_equal(port, ref)


def test_smoother_contracts_on_the_boundary():
    """GS snaps boundary rows to f; Jacobi mixes them, (1-w) v + w f."""
    rng = np.random.default_rng(9)
    v, f = (torch.from_numpy(rng.standard_normal((LM, LM))) for _ in "vf")
    bnd = ~T.ops.operators.box_interior_mask((LM, LM), LM)
    gs = stencil2d.rb_sweep_ref(v, f, LM)
    assert torch.equal(gs[bnd], f[bnd])
    jac = stencil2d.jacobi_sweep_ref(v, f, LM, OMEGA)
    assert torch.equal(jac[bnd], (1.0 - OMEGA) * v[bnd] + OMEGA * f[bnd])


# ----------------------------------------------------------------------
# (b) hierarchies and operators against the JAX package
# ----------------------------------------------------------------------

def _hierarchies(kind):
    if kind == "assembled":
        jh, _ = _reference()
        th = T.build_hierarchy(T.models.poisson2d(), device="cpu")
    else:
        jh, _ = _lean(2)
        th = T.build_lean_hierarchy(_lean_configs(2)[2], device="cpu")
    return jh, th


@pytest.mark.parametrize("kind", ["assembled", "lean"])
def test_hierarchy_arrays_match_jax(kind):
    """b, g, weights (exactly the const-5 stencil), dinv, coarse factor
    and mass class tables = the JAX package's, to 1e-13."""
    jh, th = _hierarchies(kind)
    state = _jax_state(jh)
    assert len(th.levels) == len(state["levels"])
    for tl, jl, st in zip(th.levels, jh.levels, state["levels"]):
        assert tl.n == st["n"] and tl.b.shape == st["b"].shape
        for name in ("b", "g"):
            np.testing.assert_allclose(getattr(tl, name).numpy(), st[name],
                                       rtol=0, atol=ARRAY_TOL)
        assert tl.A.offsets == st["offsets"] == dispatch.POISSON5_2D_OFFSETS
        assert tl.A.const_weights == st["weights"] \
            == dispatch.POISSON5_2D_WEIGHTS
        assert dispatch.const5_ok(tl.A)
        assert (tl.sm.dinv is None) == (st["dinv"] is None)
        assert np.array_equal(tl.sm.dinv_for(tl.A, tl.b).numpy(),
                              np.asarray(jl.sm.dinv_for(jl.A)))
    np.testing.assert_allclose(th.coarse.factor.numpy(),
                               state["coarse"]["factor"], rtol=0,
                               atol=ARRAY_TOL)
    np.testing.assert_allclose(th.M_fine.class_tables.numpy(),
                               state["class_tables"], rtol=0, atol=ARRAY_TOL)


def test_operators_match_jax():
    """The const-5 apply, its dinv and the 2D class-table mass norm on
    the reference's finest level = the JAX package's."""
    jh, _ = _reference()
    th = T.build_hierarchy(T.models.poisson2d(), device="cpu")
    u = np.random.default_rng(3).standard_normal(th.finest.b.shape)
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    jA, tA = jh.finest.A, th.finest.A
    np.testing.assert_allclose(tA.apply(tu).numpy(),
                               np.asarray(jax.jit(jA.apply)(ju)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tA.dinv(torch.float64).numpy(),
                               np.asarray(jA.dinv()), rtol=0)
    jn = jax.jit(lambda x: J.residual_norm(jh, x))(ju)
    np.testing.assert_allclose(float(T.residual_norm(th, tu)), float(jn),
                               rtol=1e-12)


def test_transfers_match_jax():
    """Injection, full weighting, P^T, bilinear and P1 prolongation on
    either diagonal, by kind, in 2D and 3D = the JAX package's."""
    rng = np.random.default_rng(5)
    for shape_f, shape_c in (((17, 17), (9, 9)), ((9, 9, 9), (5, 5, 5))):
        r, c = rng.standard_normal(shape_f), rng.standard_normal(shape_c)
        for kind in ("injection", "full_weighting", "pt"):
            np.testing.assert_allclose(
                transfer.restrict(torch.from_numpy(r), kind).numpy(),
                np.asarray(jax.jit(partial(jtransfer.restrict, kind=kind))(
                    jnp.asarray(r))),
                rtol=1e-14, atol=1e-14)
        for kind, diagonal in (("bilinear", "right"), ("p1", "right"),
                               ("p1", "left")):
            np.testing.assert_allclose(
                transfer.prolong(torch.from_numpy(c), kind, diagonal).numpy(),
                np.asarray(jax.jit(partial(jtransfer.prolong, kind=kind,
                                           diagonal=diagonal))(
                    jnp.asarray(c))),
                rtol=1e-14, atol=1e-14)
    for kind, fn in (("weighted", transfer.restrict),
                     ("cubic", transfer.prolong)):
        with pytest.raises(ValueError, match="unknown"):
            fn(torch.from_numpy(r), kind)


# ----------------------------------------------------------------------
# (c) the reference's exact run
# ----------------------------------------------------------------------

def test_reference_run_takes_63_cycles():
    """models.poisson2d() through build_hierarchy: 63 cycles as in JAX,
    histories to rtol 1e-9 / atol 1e-13, the FEM-L2 error at the CG1
    floor 1.28675e-4."""
    _, jr = _reference()
    cfg = T.models.poisson2d()
    tr = T.solve(T.build_hierarchy(cfg, device="cpu"), cfg.cycle)
    assert tr.num_cycles == 63
    _assert_histories(tr, jr, HIST_ATOL)
    assert float(tr.res_hist[62]) <= 1e-11
    assert abs(float(tr.err_hist[62]) - 1.28675e-4) < 1e-9


def test_reference_fixed_mode_matches_jax():
    """mode='fixed' (mu0 cycles on every level) on the reference's
    hierarchy: u to 1e-10 (the error norm is left to the tolerance
    solve)."""
    jh, _ = _reference()
    spec = J.config.CycleSpec(track_error=False)
    jr = _jax_solve(jh, spec, mode="fixed")
    th = T.build_hierarchy(T.models.poisson2d(), device="cpu")
    tr = T.solve(th, T.CycleSpec(track_error=False), mode="fixed")
    assert tr.num_cycles == int(jr.num_cycles) == spec.mu0
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(float(tr.res_hist[0]),
                               float(jr.res_hist[0]), rtol=RTOL,
                               atol=HIST_ATOL)


def test_reference_csv_logs_match_jax(tmp_path):
    """The reference's CSV logs of the run's histories, written by the
    port's copy of csv_io, are the JAX package's files."""
    _, jr = _reference()
    for sub, mod, hist in (("jax", jcsv, jr.res_hist),
                           ("port", csv_io, torch.tensor(
                               np.asarray(jr.res_hist)))):
        (tmp_path / sub).mkdir()
        mod.write_residual_csv(hist, 64, 3, out_dir=tmp_path / sub)
        mod.write_error_csv(hist, 64, 3, out_dir=tmp_path / sub,
                            reference_error=1.0)
        mod.append_iter_count_csv(64, 3, 63, out_dir=tmp_path / sub)
    for name in ("residual_for_64_3_levels.csv", "error_for_64_3_levels.csv",
                 "iter_count_for_diff_num_elems_3_levels.csv"):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text())


# ----------------------------------------------------------------------
# (d), (e) the lean V(2,2) red-black / P^T solve
# ----------------------------------------------------------------------

@pytest.mark.parametrize("finest_level,cycles", [(2, 3), (3, 3)])
def test_lean_rbgs_solve_matches_jax(finest_level, cycles):
    """33^2 and 65^2: 3 and 3 cycles as in JAX, res_hist to rtol 1e-9
    with a floor of 1e-15 ||b||_M."""
    _, jr = _lean(finest_level)
    _, _, tcfg, tc = _lean_configs(finest_level)
    th = T.build_lean_hierarchy(tcfg, device="cpu")
    tr = T.solve(th, tc)
    assert tr.num_cycles == cycles
    rn_ref = float(check_norm(th, torch.zeros_like(th.finest.b),
                              th.finest.b))
    _assert_histories(tr, jr, 1e-15 * rn_ref, errors=False)


def test_hierarchy_from_numpy_gives_same_solve():
    """The JAX 2D lean state carried across as numpy solves like the JAX
    package; the assembled reference state carries b and the stored
    dinv bit for bit."""
    jh, jr = _lean(2)
    cfg = _lean_configs(2)[2]
    th = T.hierarchy_from_numpy(_jax_state(jh), cfg, device="cpu")
    for tl, lv in zip(th.levels, jh.levels):
        assert np.array_equal(tl.b.numpy(), np.asarray(lv.b))
    rn_ref = float(check_norm(th, torch.zeros_like(th.finest.b),
                              th.finest.b))
    _assert_histories(T.solve(th, cfg.cycle), jr, 1e-15 * rn_ref,
                      errors=False)
    jh, _ = _reference()
    th = T.hierarchy_from_numpy(_jax_state(jh), T.models.poisson2d(),
                                device="cpu")
    for tl, lv in zip(th.levels, jh.levels):
        assert np.array_equal(tl.b.numpy(), np.asarray(lv.b))
        assert np.array_equal(tl.sm.dinv.numpy(), np.asarray(lv.sm.dinv))


# ----------------------------------------------------------------------
# dispatch, wrappers and the options outside the slice
# ----------------------------------------------------------------------

def test_dispatch_takes_plain_version_on_cpu():
    """On CPU tensors the 2D routes return the plain versions' results
    and launch nothing; the library is never built."""
    rng = np.random.default_rng(60)
    v, f = (torch.from_numpy(rng.standard_normal((17, 17))) for _ in "vf")
    c = torch.from_numpy(rng.standard_normal((9, 9)))
    kcuda.reset_launch_counts()
    assert torch.equal(dispatch.jacobi_sweep_2d(v, f, 17, OMEGA),
                       stencil2d.jacobi_sweep_ref(v, f, 17, OMEGA))
    assert torch.equal(dispatch.rb_sweep_2d(v, f, 17),
                       stencil2d.rb_sweep_ref(v, f, 17))
    assert torch.equal(dispatch.residual_2d(v, f, 17),
                       stencil2d.residual_ref(v, f, 17))
    assert torch.equal(dispatch.restrict_pt_2d(v, 17, 9),
                       stencil2d.restrict_pt_ref(v, 17, 9))
    assert torch.equal(dispatch.prolong_linear_2d(c, 17),
                       stencil2d.prolong_linear_ref(c, 17))
    assert all(n == 0 for n in kcuda.launch_counts().values())
    assert build._LIB is None


@pytest.mark.parametrize("kernel", sorted(stencil2d.LAUNCHES))
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """The 2D wrappers launch only on CUDA tensors (and only for lm up to
    46340); anything else raises before the library is built."""
    v = torch.zeros((17, 17), dtype=torch.float32)
    c = torch.zeros((9, 9), dtype=torch.float32)
    calls = {
        "jacobi_sweep_2d": lambda lm: stencil2d.jacobi_sweep(v, v, lm, 0.5),
        "rb_sweep_2d": lambda lm: stencil2d.rb_sweep(v, v, lm),
        "residual_2d": lambda lm: stencil2d.residual(v, v, lm),
        "restrict_pt_2d": lambda lm: stencil2d.restrict_pt(v, lm, 9),
        "prolong_linear_2d": lambda lm: stencil2d.prolong_linear(c, lm),
    }
    with pytest.raises(ValueError, match="CUDA tensor"):
        calls[kernel](17)
    with pytest.raises(ValueError, match="32-bit"):
        calls[kernel](stencil2d.MAX_LM + 2)
    assert build._LIB is None


def test_non_const5_operator_raises():
    """A 2D operator that is not exactly (-1, -1, 4, -1, -1) never reaches
    the const-5 kernels or their plain versions."""
    th = T.build_lean_hierarchy(_lean_configs(2)[2], device="cpu")
    lv = th.finest
    scaled = T.ops.operators.StencilOperator(
        offsets=lv.A.offsets, logical_m=lv.A.logical_m,
        grid_shape=lv.A.grid_shape,
        const_weights=tuple(2.0 * w for w in lv.A.const_weights))
    assert dispatch.const5_ok(lv.A) and not dispatch.const5_ok(scaled)
    for kind in ("rbgs", "jacobi"):
        with pytest.raises(NotImplementedError, match="K22-K24"):
            smooth(lv.sm, scaled, lv.b, lv.b, 1, kind)


@pytest.mark.parametrize("cycle,item", [
    (dict(cycle="W"), "item 8"),
    (dict(restriction="full_weighting", max_cycles=100), "item 5"),
    (dict(prolongation="p1"), "item 5"),
    (dict(cycle="F"), "item 8"),
])
def test_2d_cycle_options_outside_the_slice_raise(cycle, item):
    """The cycle options ROADMAP.md queue 1 `item` brought to the
    single-device cycle (W and F cycles, the reference's 'full_weighting'
    with its 1/16 boundary weighting, 'p1' prolongation) on the lean
    33^2 f64 solve over four levels (4^2 to 32^2 elements, so W and F
    differ) against the JAX package's plain path: the same cycle count,
    histories to rtol 1e-9 with the 1e-15 ||b||_M floor."""
    kw = {**LEAN_CYCLE, **cycle}
    jc, tc = J.config.CycleSpec(**kw), T.CycleSpec(**kw)
    shape = dict(finest_level=3, coarsest_level=0, coarsest_elements=4)
    jr = _jax_solve(J.build_lean_hierarchy(
        J.models.poisson2d(cycle=jc, **shape)), jc)
    th = T.build_lean_hierarchy(T.models.poisson2d(cycle=tc, **shape),
                                device="cpu")
    assert len(th.levels) == 4 and th.finest.n == 32, item
    tr = T.solve(th, tc)
    rn_ref = float(check_norm(th, torch.zeros_like(th.finest.b),
                              th.finest.b))
    _assert_histories(tr, jr, 1e-15 * rn_ref, errors=False)
