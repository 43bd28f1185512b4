"""The PyTorch port's distributed 2D row-strip solve (parallel/halo.py)
and its strip kernels K30-K34 (plain versions) against the JAX package
(CPU).

* The JAX Pallas dist kernels (ops/pallas/stencil2d_dist.py), called in
  interpret mode shard by shard on a 65^2 level stored as (128, 128) f32
  (2 shards of 64 rows, edge and padding rows included), against the
  port's twins on the same numpy-seeded inputs: bitwise for K30, K32 and
  K33; to atol 1e-6 for K31 (the TPU kernel forms (1-w) v + w cand, K31
  keeps K5's association) and K34 (the JAX package's own atol for its
  kernel against the single-device one).
* Stitched twins: a global array is split by the port's plan over P in
  {2, 4} ranks (33^2 over 4 leaves rank 3 all padding), each strip gets
  the halos the exchange would give it, and the concatenated outputs of
  each twin equal the port's single-device plain kernel (K6, K5, K7, K8,
  v + K9) on the global array bitwise in f32 and f64, padding rows zero.
* The plan and the strips of the rank's build.
* The distributed solves at 32^2 elements over gloo, P in {2, 3}, every
  configuration in one spawn of 3 ranks (P = 2 on a subgroup), started
  in the background when the module starts so it overlaps the JAX work:
  the JAX single-device plain solve's counts and histories (rtol 1e-9,
  floor 1e-15 ||b||_M), u gathered bitwise the port's single-device u;
  the reference's run over 3 ranks in 63 cycles; the cycler.
"""
import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch

import multigrid_dolfinx_tpu as J
from multigrid_dolfinx_tpu.ops.pallas import stencil2d_dist as pdist

import multigrid_dolfinx_tpu_torch as T
import torch_halo2d_ranks as ranks
from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
from multigrid_dolfinx_tpu_torch.ops import dispatch as tdispatch
from multigrid_dolfinx_tpu_torch.ops.cuda import stencil2d as s2
from multigrid_dolfinx_tpu_torch.ops.cuda import stencil2d_dist as sd
from multigrid_dolfinx_tpu_torch.parallel.halo import pick_shard_pad_plan
from multigrid_dolfinx_tpu_torch.parallel.halo3d import ZPlan
from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm
from multigrid_dolfinx_tpu_torch.utils.convert import halo_rows_from_numpy

torch.set_num_threads(1)

RTOL = 1e-9
WORLD = 3
SIZES = (3, 2)
KERNELS = ("rb", "jacobi", "residual", "restrict", "prolong")
W = 2.0 / 3.0
JAX_COMPILE = {"xla_backend_optimization_level": 0,
               "xla_llvm_disable_expensive_passes": True}


# ----------------------------------------------------------------------
# Shared state: the background spawn, the JAX and port solves
# ----------------------------------------------------------------------

_POOL = concurrent.futures.ThreadPoolExecutor(max_workers=1)
_CACHE = {}


def _spawn():
    if "ranks" not in _CACHE:
        _CACHE["ranks"] = _POOL.submit(
            T.run_ranks, ranks.run_configs, WORLD, "gloo", "cpu", (SIZES,))
    return _CACHE["ranks"]


@pytest.fixture(scope="module", autouse=True)
def background_ranks():
    """Start the distributed runs as the module starts."""
    _spawn()
    yield
    _POOL.shutdown(wait=True)


@pytest.fixture(scope="module")
def rank_results():
    return _spawn().result()


def _jax_solves():
    """The JAX single-device plain solves of every configuration,
    compiled as one program (one compile costs less than five)."""
    if "jax" not in _CACHE:
        names = list(ranks.CONFIGS)
        specs = [J.config.CycleSpec(**ranks.cycle_options(n)) for n in names]
        cfg = J.models.poisson2d(finest_level=2, coarsest_level=0,
                                 coarsest_elements=8, dtype="float64",
                                 cycle=specs[0])
        jh = J.build_lean_hierarchy(cfg)
        run = jax.jit(lambda h: tuple(J.fmg_solve(h, s, mode="tol")
                                      for s in specs))
        outs = run.lower(jh).compile(compiler_options=JAX_COMPILE)(jh)
        _CACHE["jax"] = dict(zip(names, outs))
    return _CACHE["jax"]


def _port_solve(cfg):
    h = T.build_lean_hierarchy(cfg, device="cpu")
    res = T.solve(h, cfg.cycle)
    return res, float(check_norm(h, torch.zeros_like(h.finest.b),
                                 h.finest.b))


# ----------------------------------------------------------------------
# (a) The JAX Pallas dist kernels against the twins
# ----------------------------------------------------------------------

LM_A, LMC_A, ROWS_A, LANES_A, SHARDS_A = 65, 33, 128, 128, 2


def _padded(rng, rows, lanes, lm):
    """A (rows, lanes) f32 array, standard normals in the lm x lm box and
    zeros in the padding (as the plan's storage holds)."""
    a = np.zeros((rows, lanes), np.float32)
    a[:lm, :lm] = rng.standard_normal((lm, lm))
    return a


def _shard(a, s, m, hp):
    """(shard s, lo strip, hi strip) of a's rows split in m-row shards,
    hp-deep strips, zeros past the edges."""
    z = np.zeros((hp, a.shape[1]), a.dtype)
    lo = a[s * m - hp:s * m] if s > 0 else z
    hi = a[(s + 1) * m:(s + 1) * m + hp] if (s + 1) * m < a.shape[0] else z
    return a[s * m:(s + 1) * m], lo, hi


def _t(a, cols):
    return torch.from_numpy(np.ascontiguousarray(a[:, :cols]))


@pytest.mark.parametrize("kind", KERNELS)
def test_pallas_dist_kernel_matches_twin(kind):
    """Each JAX stencil2d_dist kernel in interpret mode, shard by shard,
    against the port's twin: bitwise (K30, K32, K33) or to atol 1e-6
    (K31, K34), f32."""
    rng = np.random.default_rng(300 + KERNELS.index(kind))
    lm, lmc, m = LM_A, LMC_A, ROWS_A // SHARDS_A
    V, Fa = (_padded(rng, ROWS_A, LANES_A, lm) for _ in range(2))
    C = _padded(rng, ROWS_A // 2, LANES_A // 2, lmc)
    hp = pdist.HPR if kind == "restrict" else pdist.HP
    if kind == "rb":
        fn = jax.jit(lambda v, f, vlo, vhi, flo, fhi, rb: pdist.rb_sweep_dist(
            v, f, vlo, vhi, flo, fhi, lm, 4.0, -1.0, rb, interpret=True))
    elif kind == "jacobi":
        fn = jax.jit(lambda v, f, vlo, vhi, rb: pdist.jacobi_sweep_dist(
            v, f, vlo, vhi, lm, 4.0, -1.0, W, rb, interpret=True))
    elif kind == "residual":
        fn = jax.jit(lambda v, f, vlo, vhi, rb: pdist.residual_dist(
            v, f, vlo, vhi, lm, 4.0, -1.0, rb, interpret=True))
    elif kind == "restrict":
        fn = jax.jit(lambda r, rlo, rhi, rb: pdist.restrict_pt_dist(
            r, rlo, rhi, (m // 2, LANES_A // 2), lm, lmc, rb,
            interpret=True))
    else:
        fn = jax.jit(lambda c, clo, chi, v, rb: pdist.prolong_add_dist(
            c, clo, chi, v, lm, rb, interpret=True))
    for s in range(SHARDS_A):
        rb = s * m
        v, vlo, vhi = _shard(V, s, m, hp)
        f, flo, fhi = _shard(Fa, s, m, hp)
        if kind == "rb":
            ref = fn(v, f, vlo, vhi, flo, fhi, rb)
            port = sd.rb_sweep_dist_2d_ref(
                _t(v, lm), _t(f, lm), _t(vlo[-2:], lm), _t(vhi[:2], lm),
                _t(flo[-2:], lm), _t(fhi[:2], lm), lm, rb)
        elif kind == "jacobi":
            ref = fn(v, f, vlo, vhi, rb)
            tf = _t(f, lm)
            df = torch.where(sd.strip_interior(m, lm, rb, "cpu"), tf * 0.25,
                             tf)
            port = sd.jacobi_sweep_dist_2d_ref(
                _t(v, lm), df, _t(vlo[-1:], lm), _t(vhi[:1], lm), lm, W, rb)
        elif kind == "residual":
            ref = fn(v, f, vlo, vhi, rb)
            port = sd.residual_dist_2d_ref(_t(v, lm), _t(f, lm),
                                           _t(vlo[-1:], lm), _t(vhi[:1], lm),
                                           lm, rb)
        elif kind == "restrict":
            ref = fn(v, vlo, vhi, rb)
            port = sd.restrict_pt_dist_2d_ref(_t(v, lm), _t(vlo[-1:], lm), lm,
                                              lmc, rb)
        else:
            c, clo, chi = _shard(C, s, m // 2, pdist.HP)
            ref = fn(c, clo, chi, v, rb)
            port = sd.prolong_add_dist_2d_ref(_t(c, lmc), _t(chi[:1], lmc),
                                              lm, rb, _t(v, lm))
        ref = np.asarray(ref)[:, :port.shape[1]]
        if kind in ("jacobi", "prolong"):
            np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(port.numpy(), ref)


# ----------------------------------------------------------------------
# (b) Stitched twins against the single-device kernels
# ----------------------------------------------------------------------

def _strips(a, P, z, h):
    """[(strip, lo, hi)] of the global array a padded with zero rows to z
    and split over P ranks, with h-deep halos (zeros past the edges)."""
    pad = torch.zeros((z + 2 * h,) + tuple(a.shape[1:]), dtype=a.dtype)
    pad[h:h + a.shape[0]] = a
    m = z // P
    return [tuple(pad[lo:hi].contiguous() for lo, hi in (
        (h + r * m, h + (r + 1) * m), (r * m, h + r * m),
        (h + (r + 1) * m, 2 * h + (r + 1) * m))) for r in range(P)]


def _padded_rows(lm, P):
    """The padded rows of the lm^2 level of poisson2d(finest_level=3,
    coarsest_level=0) (levels 9 ... 65) under the port's plan over P."""
    plan = ZPlan.of(T.models.poisson2d(finest_level=3, coarsest_level=0),
                    P)
    return plan.zs[plan.lms.index(lm)]


@pytest.mark.parametrize("kind", KERNELS)
def test_stitched_twins_equal_single_device(kind):
    """Each strip twin, stitched over P in {2, 4} ranks at lm 33 and 65
    (33 over 4: rank 3 all padding), equals the port's single-device
    plain kernel bitwise in f32 and f64, padding rows 0."""
    rng = np.random.default_rng(400 + KERNELS.index(kind))
    for dtype in (torch.float32, torch.float64):
        for lm in (33, 65):
            lmc = (lm + 1) // 2
            v, f, c = (torch.from_numpy(rng.standard_normal((n, n))).to(dtype)
                       for n in (lm, lm, lmc))
            if kind == "rb":
                want = s2.rb_sweep_ref(v, f, lm)
            elif kind == "jacobi":
                interior = sd.strip_interior(lm, lm, 0, "cpu")
                df = torch.where(interior, f * 0.25, f)
                want = s2.jacobi_sweep_ref(v, df, lm, W)
            elif kind == "residual":
                want = s2.residual_ref(v, f, lm)
            elif kind == "restrict":
                want = s2.restrict_pt_ref(v, lm, lmc)
            else:
                want = v + s2.prolong_linear_ref(c, lm)
            for P in (2, 4):
                z = _padded_rows(lm, P)
                m = z // P
                h = 2 if kind == "rb" else 1
                vs, fs = _strips(v, P, z, h), _strips(f, P, z, h)
                outs = []
                for r in range(P):
                    (vv, vlo, vhi), (ff, flo, fhi) = vs[r], fs[r]
                    rb = r * m
                    if kind == "rb":
                        o = sd.rb_sweep_dist_2d_ref(vv, ff, vlo, vhi, flo,
                                                    fhi, lm, rb)
                    elif kind == "jacobi":
                        dd = _strips(df, P, z, 1)[r][0]
                        o = sd.jacobi_sweep_dist_2d_ref(vv, dd, vlo, vhi, lm,
                                                        W, rb)
                    elif kind == "residual":
                        o = sd.residual_dist_2d_ref(vv, ff, vlo, vhi, lm, rb)
                    elif kind == "restrict":
                        o = sd.restrict_pt_dist_2d_ref(vv, vlo, lm, lmc, rb)
                    else:
                        cc, _, chi = _strips(c, P, z // 2, 1)[r]
                        o = sd.prolong_add_dist_2d_ref(cc, chi, lm, rb, vv)
                    outs.append(o)
                got = torch.cat(outs)
                n = want.shape[0]
                assert torch.equal(got[:n], want), (kind, dtype, lm, P)
                assert not got[n:].any(), (kind, dtype, lm, P)


# ----------------------------------------------------------------------
# (c) The plan and the rank's strips
# ----------------------------------------------------------------------

def test_plan_and_strips(rank_results):
    """The plan over P in {2, 3, 4, 8}: every sharded strip holds a
    multiple of 4 rows (so every row_base is even and >= 2 rows a rank),
    the rows double up the levels, the finest covers lm; the worked
    example of (D2), 8193^2 over 4 ranks.  Each rank's b and g strips of
    the distributed build equal halo_rows_from_numpy's cut of the port's
    single-device build bitwise, padding rows zero."""
    for P in (2, 3, 4, 8):
        for finest in (2, 3, 6, 10):
            cfg = T.models.poisson2d(finest_level=finest, coarsest_level=0)
            plan, s = pick_shard_pad_plan(cfg, P)
            zp = ZPlan.of(cfg, P)
            assert s == zp.shard_from >= 1
            for li in range(s, len(plan)):
                rows, lm = plan[li]
                assert rows == zp.zs[li] >= lm == zp.lms[li]
                assert zp.mz(li) % 4 == 0 and zp.mz(li) >= 4
                if li > s:
                    assert rows == 2 * plan[li - 1][0]
            assert all(plan[li] == (lm, lm) for li, lm in
                       enumerate(zp.lms[:s]))
    plan, s = pick_shard_pad_plan(T.models.poisson2d(
        finest_level=10, coarsest_level=0, dtype="float32"), 4)
    assert s == 5 and plan[5] == (272, 257) and plan[-1] == (8704, 8193)
    h = T.build_lean_hierarchy(ranks.config("rbgs"), device="cpu")
    for P in SIZES:
        zp = ZPlan.of(ranks.config("rbgs"), P)
        for rank in range(P):
            strips = rank_results[rank][P]["strips"]
            for li, lv in enumerate(h.levels):
                for key in ("b", "g"):
                    want = halo_rows_from_numpy(getattr(lv, key).numpy(), zp,
                                                li, rank)
                    got = strips[key][li]
                    np.testing.assert_array_equal(got, want)
                    if li >= zp.shard_from:
                        m = zp.mz(li)
                        pad = np.arange(m) + rank * m >= zp.lms[li]
                        assert not got[pad].any()


# ----------------------------------------------------------------------
# (d)-(f) The distributed solves
# ----------------------------------------------------------------------

@pytest.mark.parametrize("P", SIZES)
def test_distributed_solves_match_jax(rank_results, P):
    """rbgs, Jacobi, Chebyshev (V(2,2) to rtol 1e-9), Jacobi with
    injection (4 cycles) and rbgs to the absolute tol 2e-7 over P ranks:
    the JAX single-device counts, convergence and histories (rtol 1e-9,
    floor 1e-15 ||b||_M), histories the same bits on every rank, u
    gathered bitwise the port's single-device u."""
    jax_runs = _jax_solves()
    runs = [rank_results[r][P] for r in range(P)]
    for name in ranks.CONFIGS:
        rec = runs[0][name]
        for other in runs[1:]:
            np.testing.assert_array_equal(other[name]["hist"], rec["hist"])
        jres = jax_runs[name]
        k = rec["count"]
        assert k == int(jres.num_cycles), (name, P, k, int(jres.num_cycles))
        assert rec["converged"] == bool(jres.converged), (name, P)
        port, rn_ref = _port_solve(ranks.config(name))
        np.testing.assert_allclose(rec["hist"][:k],
                                   np.asarray(jres.res_hist)[:k], rtol=RTOL,
                                   atol=1e-15 * rn_ref)
        assert np.isnan(rec["hist"][k:]).all()
        np.testing.assert_array_equal(rec["u"], port.u.numpy())


def test_reference_run_distributed(rank_results):
    """The reference's run (models.poisson2d(): 65^2 f64, FMG mu0 = 2,
    V(50,50) Jacobi, injection, tol 1e-11) over 3 ranks: 63 cycles, the
    JAX package's count; history within 1e-9 of the port's single-device
    lean solve and u gathered bitwise equal to it."""
    rec = rank_results[0]["reference"]
    assert rec["count"] == 63 and rec["converged"]
    port, rn_ref = _port_solve(T.models.poisson2d())
    assert port.num_cycles == 63
    np.testing.assert_allclose(rec["hist"][:63],
                               port.res_hist[:63].numpy(), rtol=RTOL,
                               atol=1e-15 * rn_ref)
    np.testing.assert_array_equal(rec["u"], port.u.numpy())


def test_cycler_matches_single_device(rank_results):
    """build_halo_cycler's V-cycles from zero over P in {2, 3}, gathered,
    equal as many single-device V-cycles bitwise."""
    cfg = ranks.config("rbgs")
    h = T.build_lean_hierarchy(cfg, device="cpu")
    L = h.num_levels - 1
    u = torch.zeros_like(h.finest.b)
    for _ in range(ranks.CYCLES):
        u = T.vcycle(h, cfg.cycle, L, u, h.finest.b)
    for P in SIZES:
        np.testing.assert_array_equal(rank_results[0][P]["cycler"],
                                      u.numpy())


# ----------------------------------------------------------------------
# (g) Refusals
# ----------------------------------------------------------------------

def test_dist2d_wrappers_refuse_cpu_tensors():
    """K30-K34's wrappers launch only on CUDA tensors; the dispatch sends
    a CPU tensor to the plain twin and nothing to the kernel."""
    lm, m = 9, 4
    v = torch.zeros((m, lm), dtype=torch.float64)
    h2 = torch.zeros((2, lm), dtype=torch.float64)
    h1 = h2[:1].contiguous()
    c = torch.zeros((2, 5), dtype=torch.float64)
    chi = torch.zeros((1, 5), dtype=torch.float64)
    calls = [
        lambda: sd.rb_sweep_dist_2d(v, v, h2, h2, h2, h2, lm, 0),
        lambda: sd.jacobi_sweep_dist_2d(v, v, h1, h1, lm, 0.5, 0),
        lambda: sd.residual_dist_2d(v, v, h1, h1, lm, 0),
        lambda: sd.restrict_pt_dist_2d(v, h1, lm, 5, 0),
        lambda: sd.prolong_add_dist_2d(c, chi, lm, 0, v),
    ]
    kcuda.reset_launch_counts()
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert torch.equal(tdispatch.residual_dist_2d(v, v, h1, h1, lm, 0),
                       torch.zeros_like(v))
    with pytest.raises(ValueError, match="even row"):
        sd.rb_sweep_dist_2d_ref(v, v, h2, h2, h2, h2, lm, 1)
    assert not any(kcuda.launch_counts()[k] for k in sd.LAUNCHES)


def test_refused_options_name_their_item():
    """Each refused option raises before any process group is needed and
    names what brings it: W and F cycles (item 8), full weighting and P1
    prolongation (item 5), the (px, py > 1) block layout and variable
    kappa (item 18), P2 (items 21 and 18), the LU coarse solve (refused
    by the JAX package's halo path too), 3D (halo3d); device 'cuda'
    without a card raises; the 3D builders point 2D to this path."""
    base = ranks.config("rbgs")
    refused = [(ranks.config("rbgs", **kw), item, {}) for kw, item in (
        (dict(cycle="W"), "item 8"), (dict(cycle="F"), "item 8"),
        (dict(restriction="full_weighting"), "item 5"),
        (dict(prolongation="p1"), "item 5"),
        (dict(coarse_solver="lu"), "'cholesky' or 'inverse'"))]
    refused += [
        (base, "block layout.*item 18", {"mesh_shape": (2, 2)}),
        (T.models.variable_coefficient_2d(lambda x, y: 1.0 + x,
                                          finest_level=2, cycle=base.cycle),
         "item 18", {}),
        (dataclasses.replace(base, problem=dataclasses.replace(
            base.problem, degree=2)), "items 21 and 18", {}),
        (T.models.poisson3d(finest_level=1, cycle=base.cycle),
         "build_halo_solver3d", {}),
    ]
    for cfg, item, kw in refused:
        with pytest.raises(NotImplementedError, match=item):
            T.build_halo_solver(cfg, device="cpu", **kw)
        with pytest.raises(NotImplementedError, match=item):
            T.build_halo_cycler(cfg, 2, device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.build_halo_solver(base)
    with pytest.raises(NotImplementedError, match="parallel.halo"):
        T.build_halo_solver3d(base, device="cpu")
