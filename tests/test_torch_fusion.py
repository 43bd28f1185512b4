"""The port's cycle-step fusions (K35-K37, CycleSpec.fusion) and the
red-black half sweep against the JAX package (CPU).

The plain versions of the fused kernels (the CPU path of
ops.dispatch.rb_sweep2, rb_residual_restrict, prolong_correct_rb and
rb_half_sweep) meet the JAX package's plain chains on seeded f64 inputs
to 1e-12 of the output's magnitude: the JAX chain updates a colour as
v + dinv (f - A v), the port forms K1's candidate (f + (-woff) S) / wc,
which differ by a few f64 ulps.  One case meets the JAX package's Pallas
fusion kernels themselves in interpret mode (MG_RB2 / MG_CYCLE_FUSE set)
in f32 to 2 ulps of the output's magnitude, at
tests/test_pallas_kernels.py's shape, cropped to the box.  Solves with each fusion set take the JAX package's plain cycle count
with histories to rtol 1e-9 and a floor of 1e-15 ||b||_M (as in
tests/test_torch_solve.py), and equal the port's unfused solve bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_dolfinx_tpu as J
import multigrid_dolfinx_tpu_torch as T
from multigrid_dolfinx_tpu.ops.smoothers import (multicolor_gs_smooth,
                                                 sum_parity_mask)
from multigrid_dolfinx_tpu.solver import vcycle as jvc
from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
from multigrid_dolfinx_tpu_torch.ops import dispatch
from multigrid_dolfinx_tpu_torch.ops.cuda import build, stencil3d
from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_cycle as sc
from multigrid_dolfinx_tpu_torch.ops.smoothers import smooth
from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm

torch.set_num_threads(1)

CYCLE = dict(nu1=2, nu2=2, smoother="rbgs", restriction="pt", tol=0.0,
             rtol=1e-8, max_cycles=40, track_error=False)
SHAPE = dict(finest_level=2, coarsest_level=0, coarsest_elements=8,
             dtype="float64")                 # 32^3: levels 9, 17, 33
ALL = ("rb2", "rb_restrict", "prolong_rb")
TWIN_TOL = 1e-12
RTOL = 1e-9

_CACHE = {}


def _cached(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def _hierarchies():
    """The JAX and port lean hierarchies of the 32^3 f64 problem."""
    def run():
        spec = J.config.CycleSpec(**CYCLE)
        jh = J.build_lean_hierarchy(J.models.poisson3d(cycle=spec, **SHAPE))
        th = T.build_lean_hierarchy(
            T.models.poisson3d(cycle=T.CycleSpec(**CYCLE), **SHAPE),
            device="cpu")
        return jh, th
    return _cached("hier", run)


def _inputs(lm, lmc, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((lm,) * 3), rng.standard_normal((lm,) * 3),
            rng.standard_normal((lmc,) * 3))


def _close(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=TWIN_TOL * np.abs(ref).max())


# ----------------------------------------------------------------------
# the plain versions against the JAX package's plain chains
# ----------------------------------------------------------------------

def _jax_chains(jh):
    """(name -> JAX plain chain) on the finest level and the one below."""
    lv, lv_c = jh.levels[-1], jh.levels[-2]

    def gs(v, f, n):
        return multicolor_gs_smooth(lv.sm, lv.A, v, f, n)

    def half(v, f, color):
        mask = sum_parity_mask(v.shape, parity=color)
        return jnp.where(mask, v + lv.sm.dinv_for(lv.A) * (f - lv.A.apply(v)),
                         v)

    def restrict(v, f):
        v1 = gs(v, f, 1)
        r = jvc.compute_residual(lv, v1, f)
        return v1, jvc.restrict_level(r, lv, lv_c, "pt")

    def prolong_rb(c, v, f):
        return gs(jvc.prolong_correct(c, lv_c, lv, v, "bilinear"), f, 1)

    return {
        "rb_half_sweep": jax.jit(lambda v, f, c: (half(v, f, 0),
                                                  half(v, f, 1))),
        "rb_sweep2": jax.jit(lambda v, f, c: gs(v, f, 2)),
        "rb_residual_restrict": jax.jit(lambda v, f, c: restrict(v, f)),
        "prolong_correct_rb": jax.jit(lambda v, f, c: prolong_rb(c, v, f)),
    }


def _port_twins(lm, lmc, wc, woff):
    return {
        "rb_half_sweep": lambda v, f, c: tuple(
            dispatch.rb_half_sweep(v, f, lm, wc, woff, k) for k in (0, 1)),
        "rb_sweep2": lambda v, f, c: dispatch.rb_sweep2(v, f, lm, wc, woff),
        "rb_residual_restrict": lambda v, f, c: dispatch.rb_residual_restrict(
            v, f, lm, lmc, wc, woff),
        "prolong_correct_rb": lambda v, f, c: dispatch.prolong_correct_rb(
            c, v, f, lm, wc, woff),
    }


@pytest.mark.parametrize("kernel", ["rb_half_sweep", "rb_sweep2",
                                    "rb_residual_restrict",
                                    "prolong_correct_rb"])
def test_twins_match_jax_chains(kernel):
    """Each plain version (the CPU route of ops.dispatch) = the JAX
    package's plain chain on the 33^3 level (coarse 17^3) of its lean
    build, f64, to 1e-12 of the output's magnitude: one colour of
    multicolor_gs_smooth; two sweeps of it; one sweep, then
    compute_residual and restrict_level('pt'); prolong_correct, then one
    sweep."""
    jh, th = _hierarchies()
    lv, lv_c = th.levels[-1], th.levels[-2]
    lm, lmc = lv.n + 1, lv_c.n + 1
    wc, woff = dispatch.const7_weights(lv.A)
    v, f, c = _inputs(lm, lmc, seed=len(kernel))
    kcuda.reset_launch_counts()
    port = _port_twins(lm, lmc, wc, woff)[kernel](
        *map(torch.from_numpy, (v, f, c)))
    ref = _jax_chains(jh)[kernel](*map(jnp.asarray, (v, f, c)))
    port, ref = ((port,), (ref,)) if kernel in ("rb_sweep2",
                                               "prolong_correct_rb") \
        else (port, ref)
    for a, b in zip(port, ref):
        assert a.shape == b.shape
        _close(a, b)
    assert not any(kcuda.launch_counts().values())


def test_twins_are_the_unfused_chains():
    """On the CPU the fused plain versions equal the unfused ones bitwise:
    two half sweeps are K1's plain version; K35's is K1's twice; K36's
    is K1's, then K2's; K37's is K3's, then K1's."""
    lm, lmc = 17, 9
    wc, woff = 6.0, -1.0
    v, f, c = map(torch.from_numpy, _inputs(lm, lmc, seed=3))
    s3 = stencil3d
    k1 = s3.rb_sweep_ref(v, f, lm, wc, woff)
    assert torch.equal(s3.rb_half_sweep_ref(
        s3.rb_half_sweep_ref(v, f, lm, wc, woff, 0), f, lm, wc, woff, 1), k1)
    assert torch.equal(sc.rb_sweep2_ref(v, f, lm, wc, woff),
                       s3.rb_sweep_ref(k1, f, lm, wc, woff))
    v1, fc = sc.rb_residual_restrict_ref(v, f, lm, lmc, wc, woff)
    assert torch.equal(v1, k1)
    assert torch.equal(fc, s3.restrict_residual_pt_ref(k1, f, lm, lmc, wc,
                                                       woff))
    assert torch.equal(sc.prolong_correct_rb_ref(c, v, f, lm, wc, woff),
                       s3.rb_sweep_ref(s3.prolong_linear_ref(c, lm, v), f,
                                       lm, wc, woff))


def test_plain_versions_match_pallas_fusions(monkeypatch):
    """The JAX package's Pallas fusion kernels in interpret mode
    (rb_sweep2_fused under MG_RB2=1, rb_residual_restrict_fused and
    prolong_correct_rb_fused under MG_CYCLE_FUSE=1) at lm 33 in
    (40, 40, 128) storage, f32, against the port's plain versions on the
    inputs cropped to the box, to 2 f32 ulps of the output's magnitude
    (under 1e-6 for the fine outputs, which agree bitwise here): XLA's CPU
    compiler contracts the interpret-mode residual and restriction sums
    into FMAs, which moves the coarse output by an ulp or two."""
    from multigrid_dolfinx_tpu.ops.pallas import stencil3d as js3
    from multigrid_dolfinx_tpu.ops.pallas import stencil3d_cycle as jsc

    monkeypatch.setenv("MG_RB2", "1")
    monkeypatch.setenv("MG_CYCLE_FUSE", "1")
    rng = np.random.default_rng(7)
    lmf, lmc = 33, 17
    fs, cs = (40, 40, 128), (24, 24, 128)
    wc, woff = 6.0, -1.0

    def mk(shape, lm, interior_only=False):
        x = rng.standard_normal(shape).astype(np.float32)
        m = np.zeros(shape, bool)
        lo, hi = (1, lm - 1) if interior_only else (0, lm)
        m[lo:hi, lo:hi, lo:hi] = True
        return np.where(m, x, 0.0).astype(np.float32)

    v, f, c = mk(fs, lmf), mk(fs, lmf), mk(cs, lmc, interior_only=True)
    tv, tf, tc = (torch.from_numpy(a[:lm, :lm, :lm].copy())
                  for a, lm in ((v, lmf), (f, lmf), (c, lmc)))
    jv, jf, jc = map(jnp.asarray, (v, f, c))

    def crop(a, lm):
        return np.asarray(a)[:lm, :lm, :lm]

    pairs = [
        (sc.rb_sweep2_ref(tv, tf, lmf, wc, woff),
         crop(js3.rb_sweep2_fused(jv, jf, lmf, wc, woff, interpret=True),
              lmf)),
        (sc.prolong_correct_rb_ref(tc, tv, tf, lmf, wc, woff),
         crop(jsc.prolong_correct_rb_fused(jc, jv, jf, lmf, wc, woff,
                                           interpret=True), lmf)),
    ]
    out = jsc.rb_residual_restrict_fused(jv, jf, cs, lmf, lmc, wc, woff,
                                         interpret=True)
    port = sc.rb_residual_restrict_ref(tv, tf, lmf, lmc, wc, woff)
    pairs += [(port[0], crop(out[0], lmf)), (port[1], crop(out[1], lmc))]
    for a, b in pairs:
        assert a.dtype == torch.float32 and a.shape == b.shape
        atol = 2 * np.finfo(np.float32).eps * np.abs(b).max()
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol)


# ----------------------------------------------------------------------
# solves with the fusions
# ----------------------------------------------------------------------

def _jax_solve(**cycle):
    def run():
        spec = J.config.CycleSpec(**{**CYCLE, **cycle})
        jh, _ = _hierarchies()
        return J.solve(jh, spec)
    return _cached(("solve",) + tuple(sorted(cycle.items())), run)


def _port_solve(**cycle):
    _, th = _hierarchies()
    return T.solve(th, T.CycleSpec(**{**CYCLE, **cycle})), th


@pytest.mark.parametrize("fusion,cycle", [
    (("rb2",), {}), (("rb_restrict",), {}), (("prolong_rb",), {}),
    (ALL, {}), (("rb2",), dict(nu1=3, nu2=1)), (ALL, dict(cycle="W")),
])
def test_fused_solve_matches_jax(fusion, cycle):
    """32^3 f64 with each fusion set (V(2,2); V(3,1) pairs a sweep with
    an odd remainder; a W-cycle fuses at every level transition): the
    JAX package's plain count, histories to rtol 1e-9 with the
    1e-15 ||b||_M floor, and u and the history bitwise the port's
    unfused solve; every admitted fused kernel runs (its plain version
    here: no launch is counted on the CPU)."""
    jr = _jax_solve(**cycle)
    kcuda.reset_launch_counts()
    tr, th = _port_solve(fusion=fusion, **cycle)
    plain, _ = _port_solve(**cycle)
    k = int(jr.num_cycles)
    assert tr.num_cycles == plain.num_cycles == k
    assert tr.converged and bool(jr.converged) and not tr.diverged
    rn_ref = float(check_norm(th, torch.zeros_like(th.finest.b),
                              th.finest.b))
    np.testing.assert_allclose(tr.res_hist[:k].numpy(),
                               np.asarray(jr.res_hist[:k]), rtol=RTOL,
                               atol=1e-15 * rn_ref)
    assert torch.equal(tr.u, plain.u)
    assert torch.equal(tr.res_hist[:k], plain.res_hist[:k])
    assert not any(kcuda.launch_counts().values())


def test_fusion_admission(monkeypatch):
    """cycle_fusion admits red-black, 'pt', bilinear, 3D const-7 levels
    without collect_debug; the solver calls each fused route where it is
    admitted and no other (counted through the dispatch functions)."""
    from multigrid_dolfinx_tpu_torch.solver import vcycle

    _, th = _hierarchies()
    lv = th.finest
    spec = T.CycleSpec(**CYCLE, fusion=ALL)
    assert vcycle.cycle_fusion(lv, spec, False)[0] == ALL
    for kw in (dict(smoother="jacobi"), dict(restriction="injection"),
               dict(prolongation="p1"), dict(fusion=())):
        s = T.CycleSpec(**{**CYCLE, "fusion": ALL, **kw})
        assert vcycle.cycle_fusion(lv, s, False) == ((), None), kw
    assert vcycle.cycle_fusion(lv, spec, True) == ((), None)

    calls = {}
    for name in ("rb_sweep2", "rb_residual_restrict", "prolong_correct_rb"):
        def counted(*a, _name=name, _fn=getattr(dispatch, name)):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)
        monkeypatch.setattr(dispatch, name, counted)
    vcycle.vcycle(th, spec, th.num_levels - 1, torch.zeros_like(lv.b), lv.b)
    # two fused levels (33^3, 17^3); with rb_restrict and prolong_rb each
    # V(2,2) level has one sweep left on each side: K1, not K35
    assert calls == {"rb_residual_restrict": 2, "prolong_correct_rb": 2}
    calls.clear()
    vcycle.vcycle(th, T.CycleSpec(**CYCLE, fusion=("rb2",)),
                  th.num_levels - 1, torch.zeros_like(lv.b), lv.b)
    assert calls == {"rb_sweep2": 4}


def test_rb2_smoothing_pairs_sweeps():
    """smooth(..., rb2=True) runs n // 2 double sweeps and one sweep for
    odd n: bitwise n plain sweeps; rb2 changes nothing on Jacobi or 2D."""
    _, th = _hierarchies()
    lv = th.finest
    lm = lv.n + 1
    wc, woff = dispatch.const7_weights(lv.A)
    v, f, _ = map(torch.from_numpy, _inputs(lm, 2, seed=11))
    for n in (1, 2, 3, 4):
        ref = v
        for _ in range(n):
            ref = stencil3d.rb_sweep_ref(ref, f, lm, wc, woff)
        assert torch.equal(smooth(lv.sm, lv.A, v, f, n, "rbgs", rb2=True),
                           ref)
    assert torch.equal(smooth(lv.sm, lv.A, v, f, 2, "jacobi", rb2=True),
                       smooth(lv.sm, lv.A, v, f, 2, "jacobi"))


def test_fusion_field_is_validated():
    """CycleSpec.fusion takes a tuple of distinct names from
    config.FUSIONS; () is the default."""
    assert T.CycleSpec().fusion == ()
    assert T.CycleSpec(fusion=ALL).fusion == ALL
    for bad in (("rb3",), ("rb2", "rb2")):
        with pytest.raises(ValueError, match="bad fusion"):
            T.CycleSpec(fusion=bad)
    with pytest.raises(TypeError, match="tuple"):
        T.CycleSpec(fusion=["rb2"])


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers refuse CPU tensors and boxes past MAX_LM before
    building anything."""
    v = torch.zeros((17,) * 3)
    c = torch.zeros((9,) * 3)
    calls = [lambda lm: sc.rb_sweep2(v, v, lm, 6.0, -1.0),
             lambda lm: sc.rb_residual_restrict(v, v, lm, (lm + 1) // 2,
                                                6.0, -1.0),
             lambda lm: sc.prolong_correct_rb(c, v, v, lm, 6.0, -1.0)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call(17)
        with pytest.raises(ValueError, match="32-bit"):
            call(stencil3d.MAX_LM + 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        stencil3d.rb_half_sweep(v, v, 17, 6.0, -1.0, 0)
    with pytest.raises(ValueError, match="color"):
        stencil3d.rb_half_sweep(v, v, 17, 6.0, -1.0, 2)
    assert build._LIB is None


def test_distributed_cycles_refuse_fusion():
    """The distributed builders refuse CycleSpec.fusion before any process
    group is needed: their cycles have no fused kernels."""
    cyc = T.CycleSpec(**CYCLE, fusion=("rb2",))
    for cfg, builder in (
            (T.models.poisson3d(finest_level=1, cycle=cyc),
             T.build_halo_solver3d),
            (T.models.poisson2d(finest_level=2, cycle=cyc),
             T.build_halo_solver)):
        with pytest.raises(NotImplementedError, match="single-device"):
            builder(cfg, device="cpu")
