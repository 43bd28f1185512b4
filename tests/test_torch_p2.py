"""The port's plane-free 3D P2 path (build_p2_hierarchy, the P2 kernels'
plain versions K19-K21, snap-Jacobi V-cycles, the tolerance solve and
MG-CG) against the JAX package's plain path on the CPU in f64.

Both packages build poisson3d_p2(finest_level=1, coarsest_elements=4):
two levels, lattices 9^3 and 17^3.  The JAX side (use_pallas=False) is
built once per module, and its tolerance solve and MG-CG are compiled as
one program at XLA's lowest backend optimisation level (one trace and one
compile for both: the cheapest way found on one core); its single
operator applies run op by op under `jax.disable_jit()` on the finest
level.  The solves track no error history (the FEM-L2 error norm's 660
quadrature terms would double the JAX program's trace and compile); the
port's P2 error norm is checked against exact values instead.

Tolerances, and why:
  * the template's tables are computed by the same numpy code: equal;
  * g is the same arithmetic on the same coordinates: equal; b to 1e-13
    (the lifting sums in another order);
  * operator applies, norms and the plain kernels to rtol 1e-12 (f64
    rounding in other association orders);
  * K20 snaps and mixes as the Pallas kernel does, (1-w) v + (w d)(f -
    sum_{k != c}); the JAX plain path forms v + w d (f - A v), equal
    algebraically: rtol 1e-12;
  * residual histories to rtol 1e-9 with the absolute floor of
    tests/test_torch_solve.py, 1e-15 ||b||_M;
  * u = u* at the nodes to 1e-8 (u* lies in the P2 space), and the port's
    u to 1e-12 of the JAX package's; the error norm of u* + c is |c| to
    1e-12 (the quadrature weights sum to the unit volume).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_dolfinx_tpu as J
from multigrid_dolfinx_tpu.fem import fast_p2 as jfp2
from multigrid_dolfinx_tpu.ops import smoothers as jsm
from multigrid_dolfinx_tpu.ops.operators import mass_norm as jmass_norm
from multigrid_dolfinx_tpu.solver.hierarchy import build_p2_hierarchy as jbuild
from multigrid_dolfinx_tpu.solver.krylov import mgcg_solve as jmgcg
import multigrid_dolfinx_tpu_torch as T
from multigrid_dolfinx_tpu_torch.fem import fast_p2 as tfp2
from multigrid_dolfinx_tpu_torch.ops import dispatch
from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_p2 as k2
from multigrid_dolfinx_tpu_torch.ops.operators import (box_interior_mask,
                                                       mass_norm)
from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm

torch.set_num_threads(1)

CYCLE = dict(nu1=2, nu2=2, smoother="jacobi", restriction="pt", tol=0.0,
             rtol=1e-10, max_cycles=40, track_error=False)
SHAPE = dict(finest_level=1, coarsest_level=0, coarsest_elements=4,
             dtype="float64")
B_TOL = 1e-13
OP_RTOL = 1e-12
RTOL = 1e-9
JAX_COMPILE = {"xla_backend_optimization_level": 0,
               "xla_llvm_disable_expensive_passes": True}

_CACHE = {}


def _cached(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def _configs(**cycle):
    kw = {**CYCLE, **cycle}
    jc, tc = J.config.CycleSpec(**kw), T.CycleSpec(**kw)
    return (J.models.poisson3d_p2(cycle=jc, **SHAPE), jc,
            T.models.poisson3d_p2(cycle=tc, **SHAPE), tc)


def _hierarchies():
    def run():
        jcfg, _, tcfg, _ = _configs()
        return jbuild(jcfg), T.build_p2_hierarchy(tcfg, device="cpu")
    return _cached("hier", run)


def _jax_solves():
    """(the JAX tolerance solve, its FMG-start MG-CG), one program."""
    def run():
        jh, _ = _hierarchies()
        _, jc, _, _ = _configs()

        def both(h):
            return J.fmg_solve(h, jc), jmgcg(h, jc)
        return jax.jit(both).lower(jh).compile(
            compiler_options=JAX_COMPILE)(jh)
    return _cached("solves", run)


def _port_solve():
    def run():
        _, th = _hierarchies()
        return T.solve(th, _configs()[3])
    return _cached("port_solve", run)


def _jax_state(jh):
    """The JAX P2 hierarchy as numpy arrays (the jax -> numpy step)."""
    c = jh.coarse
    return {
        "levels": [{"b": np.asarray(lv.b), "g": np.asarray(lv.g),
                    "n": lv.n, "lm": lv.n + 1, "offsets": lv.A.offsets,
                    "parity_tables": np.asarray(lv.A.parity_tables)}
                   for lv in jh.levels],
        "coarse": {"factor": np.asarray(c.factor),
                   "piv": None if c.piv is None else np.asarray(c.piv),
                   "kind": c.kind},
        "m_parity_tables": np.asarray(jh.M_fine.parity_tables),
        "m_offsets": jh.M_fine.offsets,
    }


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _rn_ref(th):
    return float(check_norm(th, torch.zeros_like(th.finest.b), th.finest.b))


def _assert_histories(t_hist, j_hist, k, atol):
    np.testing.assert_allclose(t_hist[:k].numpy(), np.asarray(j_hist[:k]),
                               rtol=RTOL, atol=atol)
    assert np.isnan(t_hist[k:].numpy()).all()


def test_template_equals_jax():
    """Offsets and the (K, 64) stiffness, mass and load tables: equal."""
    _, _, tcfg, _ = _configs()
    jt = jfp2.build_p2_template(tcfg.problem)
    tt = tfp2.build_p2_template(tcfg.problem)
    assert tt.offsets == tuple(map(tuple, jt.offsets))
    assert tt.m_offsets == tuple(map(tuple, jt.m_offsets))
    assert (len(tt.offsets), len(tt.m_offsets)) == (51, 65)
    np.testing.assert_array_equal(tt.a_unit, jt.a_unit)
    np.testing.assert_array_equal(tt.m_unit, jt.m_unit)
    np.testing.assert_array_equal(tt.load_unit, jt.load_unit)


def test_levels_match_jax():
    """Every level (9^3, 17^3): g equal, b to 1e-13, the scaled tables
    equal; the mass tables equal."""
    jh, th = _hierarchies()
    assert th.num_levels == jh.num_levels == 2
    for jl, tl in zip(jh.levels, th.levels):
        assert tl.n == jl.n and tl.b.shape == jl.b.shape
        np.testing.assert_array_equal(tl.g.numpy(), np.asarray(jl.g))
        np.testing.assert_allclose(tl.b.numpy(), np.asarray(jl.b),
                                   rtol=0, atol=B_TOL)
        np.testing.assert_array_equal(tl.A.parity_tables.numpy(),
                                      np.asarray(jl.A.parity_tables))
    np.testing.assert_array_equal(th.M_fine.parity_tables.numpy(),
                                  np.asarray(jh.M_fine.parity_tables))


def test_parity_apply_and_mass_norm_match_jax():
    """A.apply (identity mode), dinv, the raw mass apply and mass_norm on
    seeded inputs at 17^3, to rtol 1e-12."""
    jh, th = _hierarchies()
    jl, tl = jh.finest, th.finest
    with jax.disable_jit():
        u = _rand(1, tl.b.shape)
        np.testing.assert_allclose(
            tl.A.apply(torch.from_numpy(u)).numpy(),
            np.asarray(jl.A.apply(jnp.asarray(u))), rtol=OP_RTOL,
            atol=OP_RTOL)
        np.testing.assert_allclose(
            tl.A.dinv(torch.float64).numpy(), np.asarray(jl.A.dinv()),
            rtol=OP_RTOL)
        r = _rand(7, th.finest.b.shape)
        np.testing.assert_allclose(
            th.M_fine.apply(torch.from_numpy(r)).numpy(),
            np.asarray(jh.M_fine.apply(jnp.asarray(r))), rtol=OP_RTOL,
            atol=OP_RTOL)
        np.testing.assert_allclose(
            float(mass_norm(th.M_fine, torch.from_numpy(r))),
            float(jmass_norm(jh.M_fine, jnp.asarray(r))), rtol=OP_RTOL)


def test_kernels_plain_match_jax():
    """K19's and K20's plain versions against the JAX plain residual and
    snap-Jacobi sweep on seeded v, f at 17^3."""
    jh, th = _hierarchies()
    jl, tl = jh.finest, th.finest
    w = 2.0 / 3.0                            # the configs' omega
    v, f = _rand(10, tl.b.shape), _rand(20, tl.b.shape)
    tv, tf = torch.from_numpy(v), torch.from_numpy(f)
    jv, jf = jnp.asarray(v), jnp.asarray(f)
    r = k2.p2_residual_ref(tv, tf, tl.A.parity_tables, tl.A.offsets)
    out = torch.empty_like(tv)
    s = k2.p2_jacobi_sweep_ref(tv, tf, tl.A.parity_tables, tl.A.offsets, w,
                               out=out)
    with jax.disable_jit():
        jr = np.asarray(jf - jl.A.apply(jv))
        js = np.asarray(jsm.smooth(jl.sm, jl.A, jv, jf, 1, "jacobi"))
    np.testing.assert_allclose(r.numpy(), jr, rtol=OP_RTOL,
                               atol=OP_RTOL * float(np.abs(f).max()))
    assert s is out
    np.testing.assert_allclose(s.numpy(), js, rtol=OP_RTOL, atol=OP_RTOL)
    bc = ~box_interior_mask(tv.shape, tl.n + 1)
    assert torch.equal(s[bc], tf[bc])                  # the snap contract


def test_mass_quad_plain_matches_jax():
    """K21's plain version: r^T M r against the JAX plain mass_norm^2 on
    r = b (nonzero face rows: ||b||_M of the zero iterate, the JAX
    package's rn_ref) and on a seeded r; K19 + K21 on (0, b) is the same
    number; the fixed-order sum agrees with an exact sum."""
    jh, th = _hierarchies()
    M = th.M_fine
    b = th.finest.b
    with jax.disable_jit():
        for r in (b, torch.from_numpy(_rand(30, b.shape))):
            q = k2.p2_mass_quad_ref(r, M.parity_tables, M.offsets)
            qj = float(jmass_norm(jh.M_fine, jnp.asarray(r.numpy()))) ** 2
            np.testing.assert_allclose(float(q), qj, rtol=OP_RTOL)
    q0 = dispatch.p2_residual_mass_quad(
        torch.zeros_like(b), b, th.finest.A.parity_tables,
        th.finest.A.offsets, M.parity_tables, M.offsets)
    assert float(q0) == float(k2.p2_mass_quad_ref(b, M.parity_tables,
                                                  M.offsets))
    vals = torch.from_numpy(_rand(31, 70000))
    for nb in (1, 3, k2.quad_blocks(41)):
        s = float(k2.fixed_order_sum(vals, nb))
        assert s == pytest.approx(float(np.sum(vals.numpy())), rel=1e-12)


def test_tolerance_solve_matches_jax():
    """FMG + V(2,2) snap-Jacobi tolerance solve to rtol 1e-10 at 17^3: the
    JAX package's 13 cycles, histories to rtol 1e-9."""
    jr = _jax_solves()[0]
    tr = _port_solve()
    _, th = _hierarchies()
    assert int(jr.num_cycles) == tr.num_cycles == 13
    assert tr.converged and bool(jr.converged) and not tr.diverged
    _assert_histories(tr.res_hist, jr.res_hist, 13, 1e-15 * _rn_ref(th))


def test_solution_is_u_star():
    """u* = 1 + x^2 + 2y^2 + 3z^2 lies in the P2 space: the converged u
    equals it at every lattice node to 1e-8, and the JAX package's u to
    1e-12; the P2 FEM-L2 error norm (nodal slabs strided over the
    lattice) of u* is ~0 and of u* + 0.25 is 0.25."""
    _, th = _hierarchies()
    tr = _port_solve()
    lm = tr.u.shape[0]
    ax = np.arange(lm) * (1.0 / (lm - 1))
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    ustar = 1.0 + x ** 2 + 2.0 * y ** 2 + 3.0 * z ** 2
    np.testing.assert_allclose(tr.u.numpy(), ustar, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(_jax_solves()[0].u),
                               rtol=0, atol=1e-12)
    us = torch.from_numpy(ustar)
    assert float(T.error_norm(th, us)) < 1e-13
    assert float(T.error_norm(th, us + 0.25)) == pytest.approx(0.25,
                                                              rel=1e-12)


def test_mgcg_matches_jax():
    """FMG-start MG-CG with the V(2,2) snap-Jacobi preconditioner: the
    JAX package's iteration count (7), histories to rtol 1e-9."""
    _, th = _hierarchies()
    jr = _jax_solves()[1]
    tr = T.mgcg_solve(th, _configs()[3])
    assert tr.num_iters == int(jr.num_iters) == 7
    assert tr.converged and bool(jr.converged)
    _assert_histories(tr.res_hist, jr.res_hist, 7, 1e-15 * _rn_ref(th))


def test_hierarchy_from_numpy_gives_same_solve():
    """The JAX hierarchy's state carried across: the same 13 cycles and
    the port's own build's history to rtol 1e-9."""
    jh, _ = _hierarchies()
    _, _, tcfg, tc = _configs()
    hh = T.hierarchy_from_numpy(_jax_state(jh), tcfg, device="cpu")
    assert hh.M_fine.boundary_mode == "raw"
    r = T.solve(hh, tc)
    tr = _port_solve()
    assert r.num_cycles == tr.num_cycles == 13
    _assert_histories(r.res_hist, tr.res_hist, 13, 1e-15 * _rn_ref(hh))


@pytest.mark.parametrize("change,match", [
    (dict(cycle=dict(smoother="chebyshev")), "item 19"),
    (dict(cycle=dict(smoother="rbgs")), "item 22"),
    (dict(ndim=2), "item 21"),
    (dict(coarse_operator="galerkin"), "item 20"),
    (dict(kappa=lambda x, y, z: 1.0 + x), "item 20"),
    (dict(lean=True), "build_p2_hierarchy"),
])
def test_outside_the_slice_raises(change, match):
    """Chebyshev and multicolour GS on P2, 2D P2, Galerkin and
    variable-kappa P2 raise naming their ROADMAP.md items; the P1 build
    points P2 at build_p2_hierarchy."""
    cyc = T.CycleSpec(**{**CYCLE, **change.get("cycle", {})})
    ndim = change.get("ndim", 3)
    cfg = T.SolverConfig(
        problem=T.ProblemSpec(ndim=ndim, degree=2, kappa=change.get("kappa"),
                              rhs_const=-6.0 if ndim == 2 else -12.0),
        hierarchy=T.HierarchySpec(
            coarsest_elements=4, coarsest_level=0, finest_level=1,
            coarse_operator=change.get("coarse_operator", "rediscretize")),
        cycle=cyc, dtype="float64")
    build = T.build_lean_hierarchy if change.get("lean") else \
        T.build_p2_hierarchy
    with pytest.raises(NotImplementedError, match=match):
        build(cfg, device="cpu")


def test_wrappers_refuse_cpu_tensors_and_bad_offsets():
    """The CUDA wrappers take CUDA tensors only (the CPU goes to the plain
    versions through dispatch), and refuse offsets beyond radius 2."""
    _, th = _hierarchies()
    A, b = th.finest.A, th.finest.b
    with pytest.raises(ValueError, match="CUDA tensor"):
        k2.p2_residual(b, b, A.parity_tables, A.offsets)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k2.p2_jacobi_sweep(b, b, A.parity_tables, A.offsets, 0.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k2.p2_mass_quad(b, th.M_fine.parity_tables, th.M_fine.offsets)
    with pytest.raises(ValueError, match="radius"):
        k2._stencil_args(((0, 0, 0), (3, 0, 0)))
