"""Kernel K38 (residual_mass_quad, plain version) and the per-cycle check
on an uncertified class-table mass, against the JAX package (CPU).

The JAX package checks a 3D const-7 solve with its per-tet kernel only
when `M_fine.uniform_p1_mass` certifies the class tables as the uniform P1
mass; any other mass goes to its generic kernel residual_mass_quad, and an
operator that kernel refuses to the plain residual and mass norm
(solver/fmg.py _fused_residual_norm).  The port routes the same way
(fmg.check_norm: K4, K38, plain).  Here K38's twin meets the Pallas kernel
in interpret mode (f32, rtol 2e-5: the JAX package's own tolerance for
it, with tables cast to f32 and an f32 sum) and the plain JAX
quadratic_form (f64, rtol 1e-12: another association order); the solves
on an uncertified hierarchy meet the JAX plain path's counts, with
histories at rtol 1e-9 and an absolute floor of 1e-15 ||b||_M, as
tests/test_torch_solve.py holds them.
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
from multigrid_dolfinx_tpu.fem.fast_const import \
    mass_class_tables as jmass_class_tables
from multigrid_dolfinx_tpu.ops import dispatch as jdispatch
from multigrid_dolfinx_tpu.ops.operators import quadratic_form as jquad
from multigrid_dolfinx_tpu.ops.pallas import stencil3d_norm as jnorm
from multigrid_dolfinx_tpu.solver.krylov import mgcg_solve as jmgcg
from multigrid_dolfinx_tpu.solver.vcycle import compute_residual as jresidual
from multigrid_dolfinx_tpu_torch.ops import dispatch
from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_norm
from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm, residual_norm
from multigrid_dolfinx_tpu_torch.solver.vcycle import compute_residual
from multigrid_dolfinx_tpu_torch.utils.convert import hierarchy_from_numpy

torch.set_num_threads(1)

RTOL = 1e-9
KERNEL_RTOL = 1e-12
CYCLE = dict(nu1=2, nu2=2, smoother="rbgs", restriction="pt", tol=0.0,
             rtol=1e-6, max_cycles=40, track_error=False)
SHAPE = dict(finest_level=1, coarsest_level=0, coarsest_elements=8,
             dtype="float64")
JAX_COMPILE = {"xla_backend_optimization_level": 0,
               "xla_llvm_disable_expensive_passes": True}
BOX27 = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
              for c in (-1, 0, 1))


def _uncertified(h):
    """The same hierarchy with its mass stripped of the certificate (the
    StencilOperator default, uniform_p1_mass=None), in either package."""
    return dataclasses.replace(
        h, M_fine=dataclasses.replace(h.M_fine, uniform_p1_mass=None))


def _jax_run(fn, jh, **kw):
    run = jax.jit(partial(fn, **kw))
    return run.lower(jh).compile(compiler_options=JAX_COMPILE)(jh)


@pytest.fixture(scope="module")
def jax16():
    """The JAX 16^3 f64 lean hierarchy on its plain path, its uncertified
    twin, and the tolerance solve and FMG-start MG-CG on the latter."""
    spec = J.config.CycleSpec(use_pallas=False, **CYCLE)
    jh = J.build_lean_hierarchy(J.models.poisson3d(cycle=spec, **SHAPE))
    ju = _uncertified(jh)
    return {"hier": jh, "unc": ju, "spec": spec,
            "solve": _jax_run(J.fmg_solve, ju, spec=spec),
            "mgcg": _jax_run(jmgcg, ju, spec=spec)}


def _jax_state(jh, uniform_p1_mass):
    """The JAX lean hierarchy as numpy arrays (the jax -> numpy step)."""
    c = jh.coarse
    return {
        "levels": [{"b": np.asarray(lv.b), "g": np.asarray(lv.g),
                    "n": lv.n, "offsets": lv.A.offsets,
                    "weights": lv.A.const_weights,
                    "lmax": float(lv.sm.lmax), "dinv": None}
                   for lv in jh.levels],
        "coarse": {"factor": np.asarray(c.factor),
                   "piv": None if c.piv is None else np.asarray(c.piv),
                   "kind": c.kind},
        "class_tables": np.asarray(jh.M_fine.class_tables),
        "uniform_p1_mass": uniform_p1_mass,
    }


def _spy(monkeypatch):
    """Count the calls of K4's and K38's plain versions (the CPU routes)."""
    calls = {"residual_tet_quad": 0, "residual_mass_quad": 0}
    for name in calls:
        fn = getattr(stencil3d_norm, name + "_ref")

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(stencil3d_norm, name + "_ref", counted)
    return calls


def _assert_history(t_hist, j_hist, k, th):
    rn_ref = float(check_norm(th, torch.zeros_like(th.finest.b),
                              th.finest.b))
    np.testing.assert_allclose(t_hist[:k].numpy(), np.asarray(j_hist[:k]),
                               rtol=RTOL, atol=1e-15 * rn_ref)
    assert np.isnan(t_hist[k:].numpy()).all()


def _generic_tables(rng):
    """A random symmetric 27-offset class table, diagonally dominant (a
    well-conditioned q), its interior column symmetrised (T_k[13] =
    T_{-k}[13], which the JAX kernel's C_k = C_{-k} pairing assumes)."""
    t = rng.uniform(0.0, 1.0, (27, 27))
    t[13] += 30.0
    t[:, 13] = 0.5 * (t[:, 13] + t[::-1, 13])   # BOX27[26 - k] = -BOX27[k]
    return t


def test_twin_matches_jax_pallas_kernel():
    """K38's twin = the JAX kernel (Pallas interpret mode, f32) at lm 17,
    right diagonal, the JAX package's padded (24, 24, 128) storage; the
    port reads the lm^3 box of the same arrays."""
    spec = J.config.CycleSpec(use_pallas=True, **CYCLE)
    jh = J.build_lean_hierarchy(J.models.poisson3d(
        finest_level=2, coarsest_level=1, coarsest_elements=4,
        dtype="float32", cycle=spec))
    lv, M = jh.finest, jh.M_fine
    lm = lv.n + 1
    assert lm == 17 and tuple(lv.shape) == (24, 24, 128)
    rng = np.random.default_rng(38)
    box = np.zeros(lv.shape, bool)
    box[:lm, :lm, :lm] = True
    v, f = (np.where(box, rng.standard_normal(lv.shape), 0.0).astype(
        np.float32) for _ in range(2))
    wc, woff = jdispatch.const7_weights(lv.A)
    run = jax.jit(lambda vv, ff: jnorm.residual_mass_quad(
        vv, ff, M.class_tables, M.offsets, lm, wc, woff, interpret=True))
    jv, jf = jnp.asarray(v), jnp.asarray(f)
    q_jax = run.lower(jv, jf).compile(compiler_options=JAX_COMPILE)(jv, jf)
    cut = (slice(0, lm),) * 3
    q = stencil3d_norm.residual_mass_quad_ref(
        torch.from_numpy(v[cut].copy()), torch.from_numpy(f[cut].copy()),
        torch.from_numpy(np.array(M.class_tables)), M.offsets, lm, wc,
        woff)
    assert q.dtype == torch.float64 and q.ndim == 0
    np.testing.assert_allclose(float(q), float(q_jax), rtol=2e-5, atol=0.0)


@pytest.mark.parametrize("tables", ["right", "left", "generic"])
def test_twin_matches_jax_quadratic_form(jax16, tables):
    """K38's twin = JAX quadratic_form(M, r, r), r = compute_residual
    (plain), in f64, for both diagonals' P1 mass tables and a generic
    symmetric 27-offset table."""
    jh = jax16["hier"]
    lv, M = jh.finest, jh.M_fine
    lm = lv.n + 1
    rng = np.random.default_rng(380)
    if tables == "left":
        # the left diagonal's mass as the JAX lean build makes it
        problem = dataclasses.replace(J.models.poisson3d().problem,
                                      diagonal="left")
        offs, t = jmass_class_tables(problem)
        M = dataclasses.replace(M, offsets=tuple(map(tuple, offs)),
                                class_tables=jnp.asarray(
                                    t * (4.0 / (lm - 1)) ** 3),
                                uniform_p1_mass="left")
    if tables == "generic":
        M = dataclasses.replace(M, offsets=BOX27, uniform_p1_mass=None,
                                class_tables=jnp.asarray(
                                    _generic_tables(rng)))
    v, f = (rng.standard_normal((lm,) * 3) for _ in range(2))
    wc, woff = jdispatch.const7_weights(lv.A)
    r = jresidual(lv, jnp.asarray(v), jnp.asarray(f), use_pallas=False)
    q_jax = float(jquad(M, r, r))
    q = stencil3d_norm.residual_mass_quad_ref(
        torch.from_numpy(v), torch.from_numpy(f),
        torch.from_numpy(np.array(M.class_tables)), M.offsets, lm, wc,
        woff)
    np.testing.assert_allclose(float(q), q_jax, rtol=KERNEL_RTOL)


def test_uncertified_solve_matches_jax(jax16, monkeypatch):
    """16^3 f64 with uniform_p1_mass=None: the check runs on K38 (its twin
    here) and never on K4; the JAX plain path's cycle count and history,
    and the port's certified solve's count."""
    jr = jax16["solve"]
    k = int(jr.num_cycles)
    tc = T.CycleSpec(**CYCLE)
    th = T.build_lean_hierarchy(T.models.poisson3d(cycle=tc, **SHAPE),
                                device="cpu")
    certified = T.solve(th, tc)
    tu = _uncertified(th)
    calls = _spy(monkeypatch)
    tr = T.solve(tu, tc)
    assert calls == {"residual_tet_quad": 0, "residual_mass_quad": k + 1}
    assert tr.num_cycles == k == certified.num_cycles
    assert tr.converged and bool(jr.converged)
    _assert_history(tr.res_hist, jr.res_hist, k, tu)
    assert torch.equal(tr.u, certified.u)


def test_uncertified_mgcg_matches_jax(jax16, monkeypatch):
    """MG-CG from FMG (solve_mgcg) on the uncertified hierarchy: K38's
    twin is its check, with the JAX package's iteration count."""
    jr = jax16["mgcg"]
    k = int(jr.num_iters)
    tc = T.CycleSpec(**CYCLE)
    tu = _uncertified(T.build_lean_hierarchy(
        T.models.poisson3d(cycle=tc, **SHAPE), device="cpu"))
    calls = _spy(monkeypatch)
    tr = T.solve_mgcg(tu, tc)
    assert calls["residual_tet_quad"] == 0
    assert calls["residual_mass_quad"] == k + 1
    assert tr.num_iters == k and tr.converged and bool(jr.converged)
    _assert_history(tr.res_hist, jr.res_hist, k, tu)


def test_hierarchy_from_numpy_carries_an_uncertified_mass(jax16,
                                                          monkeypatch):
    """hierarchy_from_numpy with "uniform_p1_mass": None keeps the mass
    uncertified; the loaded hierarchy's check routes to K38's twin and
    the solve takes the JAX package's count."""
    jr = jax16["solve"]
    k = int(jr.num_cycles)
    tc = T.CycleSpec(**CYCLE)
    th = hierarchy_from_numpy(_jax_state(jax16["unc"], None),
                              T.models.poisson3d(cycle=tc, **SHAPE),
                              device="cpu")
    assert th.M_fine.uniform_p1_mass is None
    assert dispatch.mass_quad_admits(th.M_fine)
    calls = _spy(monkeypatch)
    tr = T.solve(th, tc)
    assert calls == {"residual_tet_quad": 0, "residual_mass_quad": k + 1}
    assert tr.num_cycles == k and tr.converged
    _assert_history(tr.res_hist, jr.res_hist, k, th)


def test_mass_quad_admits_mirrors_jax_refusals(monkeypatch):
    """An asymmetric pattern, a missing centre and radius 2: the JAX
    kernel returns None (before any launch), mass_quad_admits refuses,
    K38's twin raises, and check_norm takes the plain branch (the
    residual and the class-table norm), as the JAX package does."""
    tc = T.CycleSpec(**CYCLE)
    th = T.build_lean_hierarchy(T.models.poisson3d(cycle=tc, **SHAPE),
                                device="cpu")
    lv, M = th.finest, th.M_fine
    lm = lv.n + 1
    offs = M.offsets
    centre = offs.index((0, 0, 0))
    cases = {
        "asymmetric": [k for k in range(len(offs)) if offs[k] != (1, 1, 1)],
        "no centre": [k for k in range(len(offs)) if k != centre],
        "radius 2": list(range(len(offs))) + [centre],
    }
    rng = np.random.default_rng(381)
    v, f = (torch.from_numpy(rng.standard_normal((lm,) * 3))
            for _ in range(2))
    wc, woff = dispatch.const7_weights(lv.A)
    jv = jnp.zeros((24, 24, 128), jnp.float32)
    for name, keep in cases.items():
        o = [offs[k] for k in keep]
        if name == "radius 2":
            o[-1] = (2, 0, 0)
        tables = M.class_tables[keep].clone()
        assert jnorm.residual_mass_quad(
            jv, jv, jnp.asarray(tables.numpy(), jnp.float32), o, lm, wc, woff,
            interpret=True) is None, name
        Mx = dataclasses.replace(M, offsets=tuple(o), class_tables=tables,
                                 uniform_p1_mass=None)
        assert not dispatch.mass_quad_admits(Mx), name
        with pytest.raises(ValueError, match="residual_mass_quad"):
            stencil3d_norm.residual_mass_quad_ref(v, f, tables, o, lm, wc,
                                                  woff)
        hx = dataclasses.replace(th, M_fine=Mx)
        calls = _spy(monkeypatch)
        got = check_norm(hx, v, f)
        assert calls == {"residual_tet_quad": 0, "residual_mass_quad": 0}
        assert torch.equal(got, residual_norm(hx, compute_residual(lv, v, f)))
        monkeypatch.undo()
