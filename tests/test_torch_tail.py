"""The PyTorch port's fused coarse tail (K13 tail_down, K14 tail_up)
against the JAX package's (CPU).

The plain versions run the per-level plain K1-K3 sequence.  They meet the
JAX tail kernels run in Pallas interpret mode on the same numpy-seeded
right-hand side, to 8 f32 ulps of the output's magnitude: XLA's CPU
compiler contracts some of the interpret-mode products into FMAs, which
the port's plain versions (and its kernels, built with --fmad=false) do
not.  The port's V-cycle takes the tail exactly where the JAX package
does, and gives bitwise the V-cycle of its per-level path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_dolfinx_tpu as J
import multigrid_dolfinx_tpu_torch as T
from multigrid_dolfinx_tpu.ops.pallas import stencil3d_tail as jtail
from multigrid_dolfinx_tpu.solver.vcycle import _fused_tail_levels
from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
from multigrid_dolfinx_tpu_torch.ops import dispatch
from multigrid_dolfinx_tpu_torch.ops.cuda import build, stencil3d_tail
from multigrid_dolfinx_tpu_torch.solver import vcycle as tvcycle

torch.set_num_threads(1)

RBGS = dict(nu1=2, nu2=2, smoother="rbgs", restriction="pt", tol=0.0,
            rtol=1e-6, max_cycles=20, track_error=False)
ULPS = 8 * float(np.finfo(np.float32).eps)

_CACHE = {}


def _hierarchies(finest_level, dtype="float32", cycle=RBGS):
    key = (finest_level, dtype, tuple(sorted(cycle.items())))
    if key not in _CACHE:
        shape = dict(finest_level=finest_level, coarsest_level=0,
                     coarsest_elements=8, dtype=dtype)
        jc = J.config.CycleSpec(use_pallas=True, **cycle)
        tc = T.CycleSpec(**cycle)
        jh = J.build_lean_hierarchy(J.models.poisson3d(cycle=jc, **shape))
        th = T.build_lean_hierarchy(T.models.poisson3d(cycle=tc, **shape),
                                    device="cpu")
        _CACHE[key] = (jh, jc, th, tc)
    return _CACHE[key]


def _close(port, ref, lm):
    ref = np.asarray(ref)[:lm, :lm, :lm]
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=ULPS * np.abs(ref).max())


@pytest.mark.parametrize("j", [1, 2])
def test_tail_plain_versions_match_jax_tail(j):
    """Both legs on a random right-hand side at the top of the tail (17^3
    over 9^3, 33^3 over 17^3 and 9^3): the pre-smoothed v and the
    restricted f of every level, and the up leg's result from the same
    coarse solution."""
    jh, jc, th, tc = _hierarchies(2)
    levels = _fused_tail_levels(jh, jc, j)
    assert levels is not None
    lms, weights = tvcycle.fused_tail_levels(th, tc, j)
    assert lms == tuple(lv[0] for lv in levels)
    top = jh.levels[j]
    lm = lms[-1]
    rng = np.random.default_rng(200 + j)
    f = rng.standard_normal((lm,) * 3).astype(np.float32)
    f_pad = np.zeros(top.shape, np.float32)
    f_pad[:lm, :lm, :lm] = f
    outs = jtail.tail_down(jnp.asarray(f_pad), levels, 2, interpret=True)
    jvs, jfs = outs[:j], outs[j:]
    tvs, tfs = stencil3d_tail.tail_down_ref(torch.from_numpy(f), lms,
                                            weights, 2)
    for k in range(j):
        _close(tvs[k], jvs[k], lms[j - k])
        _close(tfs[k], jfs[k], lms[j - 1 - k])
    v0 = th.coarse.solve(tfs[-1])
    v0_pad = np.zeros(jh.levels[0].shape, np.float32)
    v0_pad[:lms[0], :lms[0], :lms[0]] = v0.numpy()
    j_up = jtail.tail_up(jnp.asarray(v0_pad), jnp.asarray(f_pad), jvs, jfs[:-1], levels, 2,
                         interpret=True)
    t_up = stencil3d_tail.tail_up_ref(v0, torch.from_numpy(f), tvs, tfs[:-1],
                                      lms, weights, 2)
    _close(t_up, j_up, lm)


@pytest.mark.parametrize("dtype,cycle", [
    ("float32", RBGS),
    ("float64", RBGS),
    ("float32", dict(RBGS, smoother="jacobi")),
    ("float32", dict(RBGS, smoother="chebyshev")),
])
def test_tail_applies_where_jax_applies_it(dtype, cycle):
    """fused_tail_levels gives the JAX package's levels (sizes and
    weights, which the two builds scale in other orders: a few f64 ulps)
    on every sub-hierarchy of a 65^3 lean hierarchy: f32 red-black
    V-cycles only, the top at most 65^3."""
    jh, jc, th, tc = _hierarchies(3, dtype, cycle)
    seen = 0
    for j in range(th.num_levels):
        jl = _fused_tail_levels(jh, jc, j)
        tl = tvcycle.fused_tail_levels(th, tc, j)
        assert (jl is None) == (tl is None), j
        if tl is not None:
            seen += 1
            assert tl[0] == tuple(lv[0] for lv in jl)
            np.testing.assert_allclose(np.array(tl[1]),
                                       np.array([lv[2:] for lv in jl]),
                                       rtol=1e-14)
    assert seen == (3 if dtype == "float32" and cycle is RBGS else 0)


def test_vcycle_through_the_tail_equals_the_per_level_vcycle(monkeypatch):
    """An f32 red-black V-cycle at 65^3 runs the tail below its top level
    (levels 9..33, once per cycle) and gives bitwise the V-cycle of the
    per-level path."""
    _, _, th, tc = _hierarchies(3)
    calls = []
    real = dispatch.tail_down

    def spy(f_top, lms, weights, nu1):
        calls.append(lms)
        return real(f_top, lms, weights, nu1)

    monkeypatch.setattr(dispatch, "tail_down", spy)
    L = th.num_levels - 1
    f = th.finest.b
    v0 = torch.zeros_like(f)
    v_tail = T.vcycle(th, tc, L, v0, f)
    assert calls == [(9, 17, 33)]
    monkeypatch.setattr(tvcycle, "TAIL_MAX_LM", 0)
    v_ref = T.vcycle(th, tc, L, v0, f)
    assert calls == [(9, 17, 33)]
    assert torch.equal(v_tail, v_ref)


def test_tail_dispatch_takes_plain_version_on_cpu():
    """On CPU tensors K13/K14 route to their plain versions and launch
    nothing; the library is never built."""
    _, tc, th, _ = _hierarchies(2)
    lms, weights = tvcycle.fused_tail_levels(th, T.CycleSpec(**RBGS), 2)
    f = torch.from_numpy(np.random.default_rng(210).standard_normal(
        (33,) * 3).astype(np.float32))
    kcuda.reset_launch_counts()
    vs, fs = dispatch.tail_down(f, lms, weights, 2)
    rvs, rfs = stencil3d_tail.tail_down_ref(f, lms, weights, 2)
    assert all(torch.equal(a, b) for a, b in zip(vs + fs, rvs + rfs))
    v0 = th.coarse.solve(fs[-1])
    assert torch.equal(
        dispatch.tail_up(v0, f, vs, fs[:-1], lms, weights, 2),
        stencil3d_tail.tail_up_ref(v0, f, vs, fs[:-1], lms, weights, 2))
    assert all(n == 0 for n in kcuda.launch_counts().values())
    assert build._LIB is None


def test_tail_wrappers_refuse_cpu_tensors_and_bad_levels():
    """K13/K14 launch only on CUDA tensors and only on a chain of 2..8
    halving levels; anything else raises before the library is built."""
    w = ((0.75, -0.125), (0.375, -0.0625))
    f = torch.zeros((17,) * 3, dtype=torch.float32)
    v0 = torch.zeros((9,) * 3, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        stencil3d_tail.tail_down(f, (9, 17), w, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        stencil3d_tail.tail_up(v0, f, [f], [], (9, 17), w, 2)
    with pytest.raises(ValueError, match="halvings"):
        stencil3d_tail.tail_down(f, (9, 19), w, 2)
    with pytest.raises(ValueError, match="2..8 levels"):
        stencil3d_tail.tail_down(f, (17,), w[:1], 2)
    assert build._LIB is None
