"""The PyTorch port's distributed 3D z-slab solve (parallel/halo3d.py) and
its slab kernels K25-K29 (plain versions) against the JAX package (CPU,
f64).

* Stitched twins: a global array is split by the port's plan over P in
  {2, 4} ranks, each block gets the halos the exchange would give it, and
  the concatenated outputs of each twin equal the port's single-device
  plain kernel (K1, K11, K10, K2, K3) on the global array bitwise, padding
  rows zero; and the JAX package's single-device plain function
  (use_pallas=False) to rtol 1e-12.  Not bitwise there: the JAX plain path
  associates differently (tests/test_torch_kernels.py), and
  tests/test_pallas_kernels.py pins it to the Pallas kernels.
* The JAX Pallas dist kernels themselves, called directly in interpret
  mode on one interior block with explicit halos and z_base (storage
  zero-padded to the (8, 24, 128) tile shape, compared after cropping),
  against the twins to 1e-12 of the output's magnitude.
* The plan against the JAX pick_z_shard_plan(align=True).
* The distributed solves at 32^3 elements over gloo, P in {2, 4}, every
  configuration in one spawn of 4 ranks (P = 2 on a subgroup), started
  in the background when the module starts so it overlaps the JAX work:
  the JAX single-device plain solve's counts and histories (rtol 1e-9,
  floor 1e-15 ||b||_M); the port's single-device u bitwise for V-cycle
  solves and to 1e-12 for MG-CG (its dots are summed in another order);
  resumed == uninterrupted bitwise; the smoother builders, halo_extend_z
  and the cycler against their single-device counterparts, bitwise.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import multigrid_dolfinx_tpu as J
from multigrid_dolfinx_tpu.ops import dispatch as jdispatch
from multigrid_dolfinx_tpu.ops.pallas import stencil3d_dist as pdist
from multigrid_dolfinx_tpu.ops.smoothers import jacobi_smooth as jjacobi
from multigrid_dolfinx_tpu.ops.smoothers import multicolor_gs_smooth
from multigrid_dolfinx_tpu.parallel.halo3d import \
    pick_z_shard_plan as jpick_plan
from multigrid_dolfinx_tpu.solver.krylov import mgcg_solve as jmgcg
from multigrid_dolfinx_tpu.solver.vcycle import (compute_residual,
                                                 prolong_level,
                                                 restrict_level)

import multigrid_dolfinx_tpu_torch as T
import torch_halo3d_ranks as ranks
from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
from multigrid_dolfinx_tpu_torch.ops import dispatch as tdispatch
from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d as s3
from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_dist as sd
from multigrid_dolfinx_tpu_torch.parallel.halo3d import (ZPlan,
                                                         pick_z_shard_plan)
from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm
from multigrid_dolfinx_tpu_torch.utils.convert import halo_slab_from_numpy

torch.set_num_threads(1)

RTOL = 1e-9
KERNEL_RTOL = 1e-12
SIZES = (4, 2)
KERNELS = ("rb", "jacobi", "residual", "restrict", "prolong")
JAX_COMPILE = {"xla_backend_optimization_level": 0,
               "xla_llvm_disable_expensive_passes": True}


# ----------------------------------------------------------------------
# Shared state: the background spawn, the JAX hierarchy and solves
# ----------------------------------------------------------------------

_POOL = concurrent.futures.ThreadPoolExecutor(max_workers=1)
_CACHE = {}


def _spawn():
    if "ranks" not in _CACHE:
        _CACHE["ranks"] = _POOL.submit(
            T.run_ranks, ranks.run_configs, max(SIZES), "gloo", "cpu",
            (list(ranks.CONFIGS), SIZES))
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


def _jax_cfg(name, **override):
    jc = J.config.CycleSpec(**ranks.cycle_options(name, **override))
    return J.models.poisson3d(finest_level=2, coarsest_level=0,
                              coarsest_elements=8, dtype="float64",
                              cycle=jc), jc


@pytest.fixture(scope="module")
def jhier():
    """The JAX lean hierarchy of the solves (levels 9^3, 17^3, 33^3)."""
    return J.build_lean_hierarchy(_jax_cfg("rbgs")[0])


def _jax_solve(jh, name):
    """The JAX single-device solve of configuration `name`: all of them
    compiled as one program (one compile costs less than five)."""
    if "jax" not in _CACHE:
        names = [n for n in ranks.CONFIGS if n != "resume"]

        def solve(n, h):
            spec = _jax_cfg(n)[1]
            if ranks.CONFIGS[n][1] == "mgcg":
                return jmgcg(h, spec, fmg_start=True)
            return J.fmg_solve(h, spec, mode="tol")

        run = jax.jit(lambda h: tuple(solve(n, h) for n in names))
        outs = run.lower(jh).compile(compiler_options=JAX_COMPILE)(jh)
        _CACHE["jax"] = dict(zip(names, outs))
    return _CACHE["jax"][name]


def _port_solve(name):
    key = ("port", name)
    if key not in _CACHE:
        cfg = ranks.config(name)
        h = T.build_lean_hierarchy(cfg, device="cpu")
        res = (T.mgcg_solve(h, cfg.cycle) if ranks.CONFIGS[name][1] == "mgcg"
               else T.solve(h, cfg.cycle))
        rn_ref = float(check_norm(h, torch.zeros_like(h.finest.b),
                                  h.finest.b))
        _CACHE[key] = (res, rn_ref)
    return _CACHE[key]


# ----------------------------------------------------------------------
# Splitting a global array the way the plan and the exchange do
# ----------------------------------------------------------------------

def _blocks(a, P, z, h):
    """[(block, lo, hi)] of the global array a (lm rows) padded with zero
    rows to z and split over P ranks, with h-deep halos."""
    pad = np.zeros((z + 2 * h,) + a.shape[1:])
    pad[h:h + a.shape[0]] = a
    mz = z // P
    out = []
    for r in range(P):
        s = h + r * mz
        out.append(tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in
                         (pad[s:s + mz], pad[s - h:s], pad[s + mz:s + mz + h])))
    return out


def _padded_z(lm, P):
    """The padded z of the lm^3 level of the solves' hierarchy (levels 9,
    17, 33) under the port's plan over P ranks."""
    plan = ZPlan.of(ranks.config("rbgs"), P)
    return plan.zs[plan.lms.index(lm)]


def _stitched(kind, lm, P, v, f, c, wc, woff, w):
    """The twin of `kind` run block by block and concatenated."""
    z = _padded_z(lm, P)
    mz = z // P
    h = 2 if kind in ("rb", "restrict") else 1
    vb, fb = _blocks(v, P, z, h), _blocks(f, P, z, h)
    outs = []
    for r in range(P):
        (vv, vlo, vhi), (ff, flo, fhi) = vb[r], fb[r]
        zb = r * mz
        if kind == "rb":
            o = sd.rb_sweep_dist_ref(vv, ff, vlo, vhi, flo, fhi, lm, wc, woff,
                                     zb)
        elif kind == "jacobi":
            o = sd.jacobi_sweep_dist_ref(vv, ff, vlo, vhi, flo, fhi, lm, wc,
                                         woff, w, zb)
        elif kind == "residual":
            o = sd.residual_dist_ref(vv, ff, vlo, vhi, flo, fhi, lm, wc,
                                     woff, zb)
        elif kind == "restrict":
            o = sd.restrict_residual_pt_dist_ref(
                vv, ff, vlo, vhi, flo, fhi, lm, (lm + 1) // 2, wc, woff, zb)
        else:
            cb = _blocks(c, P, z // 2, 1)
            cc, _, chi = cb[r]
            o = sd.prolong_linear_dist_ref(cc, chi[:1], lm, zb, vv)
        outs.append(o)
    return torch.cat(outs)


def _single(kind, lm, v, f, c, wc, woff, w):
    """The port's single-device plain kernel on the global array."""
    v, f = torch.from_numpy(v), torch.from_numpy(f)
    if kind == "rb":
        return s3.rb_sweep_ref(v, f, lm, wc, woff)
    if kind == "jacobi":
        return s3.jacobi_sweep_ref(v, f, lm, wc, woff, w)
    if kind == "residual":
        return s3.residual_ref(v, f, lm, wc, woff)
    if kind == "restrict":
        return s3.restrict_residual_pt_ref(v, f, lm, (lm + 1) // 2, wc, woff)
    return s3.prolong_linear_ref(torch.from_numpy(c), lm, v)


def _jax_single(kind, jh, lidx, v, f, c):
    """The JAX package's single-device plain function."""
    lv, lv_c = jh.levels[lidx], jh.levels[lidx - 1]
    v, f = jnp.asarray(v), jnp.asarray(f)
    if kind == "rb":
        return jax.jit(lambda a, b: multicolor_gs_smooth(lv.sm, lv.A, a, b,
                                                         1))(v, f)
    if kind == "jacobi":
        return jax.jit(lambda a, b: jjacobi(lv.sm, a, b, 1, A=lv.A))(v, f)
    if kind == "residual":
        return jax.jit(lambda a, b: compute_residual(lv, a, b))(v, f)
    if kind == "restrict":
        return jax.jit(lambda a, b: restrict_level(
            compute_residual(lv, a, b), lv, lv_c, "pt"))(v, f)
    return v + jax.jit(lambda cc: prolong_level(cc, lv_c, lv, "bilinear"))(
        jnp.asarray(c))


def _close(port, ref, rtol=KERNEL_RTOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("kind", KERNELS)
def test_stitched_twins_equal_single_device(jhier, kind):
    """Each slab twin, stitched over P in {2, 4} ranks at lm 17 and 33,
    equals the port's single-device plain kernel bitwise (padding rows
    0) and the JAX single-device plain function to 1e-12."""
    rng = np.random.default_rng(100 + KERNELS.index(kind))
    for lidx in (1, 2):
        lv = jhier.levels[lidx]
        lm, lmc = lv.n + 1, lv.n // 2 + 1
        wc, woff = jdispatch.const7_weights(lv.A)
        w = float(lv.sm.omega)
        v, f = rng.standard_normal((2, lm, lm, lm))
        c = rng.standard_normal((lmc,) * 3)
        want = _single(kind, lm, v, f, c, wc, woff, w)
        for P in (2, 4):
            got = _stitched(kind, lm, P, v, f, c, wc, woff, w)
            n = want.shape[0]
            assert torch.equal(got[:n], want), (kind, lm, P)
            assert not got[n:].any(), (kind, lm, P)
        _close(want, _jax_single(kind, jhier, lidx, v, f, c))


@pytest.mark.parametrize("kind", KERNELS)
def test_pallas_dist_kernel_matches_twin(kind):
    """The JAX Pallas dist kernel in interpret mode on one interior block
    (global lm 17, 8 slabs from z 4) against the port's twin."""
    lm, mz, zb, lmc = 17, 8, 4, 9
    wc, woff = 6.0 / 28.0 * 17, -1.0 / 28.0 * 17
    rng = np.random.default_rng(200 + KERNELS.index(kind))
    V = np.zeros((lm + 8, lm, lm))
    Fz = np.zeros((lm + 8, lm, lm))
    V[:lm], Fz[:lm] = rng.standard_normal((2, lm, lm, lm))
    C = np.zeros((16, lmc, lmc))
    C[:lmc] = rng.standard_normal((lmc,) * 3)
    h = 2 if kind in ("rb", "restrict") else 1

    def tile(a, y=24, x=128):
        out = np.zeros((a.shape[0], y, x))
        out[:, :a.shape[1], :a.shape[2]] = a
        return jnp.asarray(out)

    def parts(A):
        return A[zb:zb + mz], A[zb - h:zb], A[zb + mz:zb + mz + h]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    (v, vlo, vhi), (f, flo, fhi) = parts(V), parts(Fz)
    jargs = [tile(a) for a in (v, f, vlo, vhi, flo, fhi)]
    targs = [t(a) for a in (v, f, vlo, vhi, flo, fhi)]
    if kind == "rb":
        ref = pdist.rb_sweep_fused_dist(*jargs, lm, wc, woff, zb,
                                        interpret=True)
        port = sd.rb_sweep_dist_ref(*targs, lm, wc, woff, zb)
    elif kind == "jacobi":
        ref = pdist.jacobi_sweep_dist(*jargs, lm, wc, woff, 2.0 / 3.0, zb,
                                      interpret=True)
        port = sd.jacobi_sweep_dist_ref(*targs, lm, wc, woff, 2.0 / 3.0, zb)
    elif kind == "residual":
        ref = pdist.residual_dist(*jargs, lm, wc, woff, zb, interpret=True)
        port = sd.residual_dist_ref(*targs, lm, wc, woff, zb)
    elif kind == "restrict":
        ref = pdist.restrict_residual_pt_dist(
            *jargs, (mz // 2, 16, 128), lm, lmc, wc, woff, zb, zb // 2,
            interpret=True)
        port = sd.restrict_residual_pt_dist_ref(*targs, lm, lmc, wc, woff,
                                                zb)
    else:
        c, chi = C[zb // 2:zb // 2 + mz // 2], C[zb // 2 + mz // 2:][:1]
        ref = pdist.prolong_linear_add_dist(
            tile(c, 16, 128), tile(chi, 16, 128), jargs[0], lm, zb,
            interpret=True)
        port = sd.prolong_linear_dist_ref(t(c), t(chi), lm, zb, targs[0])
    n = port.shape[1]
    _close(port, np.asarray(ref)[:, :n, :n])


def test_plan_matches_jax():
    """The z entries of the sharded levels and shard_from equal the JAX
    package's pick_z_shard_plan(align=True); the slab counts are multiples
    of 4 (even z_base everywhere); under align=False (its y/x unpadded
    there too) the whole plan equals JAX's, at min_slab 2 and 4; the
    worked examples of the design."""
    for ngz in (2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:ngz]), ("gz",))
        for finest in (2, 3, 4, 6, 7):
            kw = dict(finest_level=finest, coarsest_level=0,
                      coarsest_elements=8)
            want, ws = jpick_plan(J.models.poisson3d(**kw), mesh, align=True)
            got, gs = pick_z_shard_plan(T.models.poisson3d(**kw), ngz)
            assert gs == ws, (ngz, finest)
            assert [p[0] for p in got[gs:]] == [p[0] for p in want[ws:]]
            plan = ZPlan.of(T.models.poisson3d(**kw), ngz)
            assert all(plan.mz(li) % 4 == 0
                       for li in range(gs, len(plan.lms)))
            for min_slab in (2, 4):
                got = pick_z_shard_plan(T.models.poisson3d(**kw), ngz,
                                        min_slab=min_slab, align=False)
                want = jpick_plan(J.models.poisson3d(**kw), mesh,
                                  min_slab=min_slab, align=False)
                assert got == want, (ngz, finest, min_slab)
    cases = {(6, 4): (5, (272, 544)), (7, 8): (6, (544, 1088)),
             (2, 4): (1, (32, 64))}
    for (finest, ngz), (s, zs) in cases.items():
        plan = ZPlan.of(T.models.poisson3d(finest_level=finest,
                                           coarsest_level=0,
                                           coarsest_elements=8), ngz)
        assert plan.shard_from == s and plan.zs[s:] == zs


def test_dist_wrappers_refuse_cpu_tensors():
    """K25-K29's wrappers launch only on CUDA tensors; the dispatch sends
    a CPU tensor to the plain twin and nothing to the kernel."""
    lm, mz = 9, 4
    v = torch.zeros((mz, lm, lm), dtype=torch.float64)
    h2 = torch.zeros((2, lm, lm), dtype=torch.float64)
    h1 = h2[:1].contiguous()
    c = torch.zeros((2, 5, 5), dtype=torch.float64)
    chi = torch.zeros((1, 5, 5), dtype=torch.float64)
    calls = [
        lambda: sd.rb_sweep_dist(v, v, h2, h2, h2, h2, lm, 6.0, -1.0, 0),
        lambda: sd.jacobi_sweep_dist(v, v, h1, h1, h1, h1, lm, 6.0, -1.0,
                                     0.5, 0),
        lambda: sd.residual_dist(v, v, h1, h1, h1, h1, lm, 6.0, -1.0, 0),
        lambda: sd.restrict_residual_pt_dist(v, v, h2, h2, h2, h2, lm, 5,
                                             6.0, -1.0, 0),
        lambda: sd.prolong_linear_dist(c, chi, lm, 0, v),
    ]
    kcuda.reset_launch_counts()
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert torch.equal(tdispatch.residual_dist(v, v, h1, h1, h1, h1, lm, 6.0,
                                              -1.0, 0), torch.zeros_like(v))
    assert not any(kcuda.launch_counts()[k] for k in sd.LAUNCHES)


def test_refused_options_name_their_item():
    """Each refused option raises before any process group is needed and
    names the ROADMAP item that brings it: W and F cycles (item 8), full
    weighting and P1 prolongation (item 5), variable kappa
    (halo3d_var), P2 (halo3d_p2) and 2D (queue 2 item 14)."""
    cyc = ranks.config("rbgs").cycle
    refused = [(ranks.config("rbgs", **kw), item) for kw, item in (
        (dict(cycle="W"), "item 8"), (dict(cycle="F"), "item 8"),
        (dict(restriction="full_weighting"), "item 5"),
        (dict(prolongation="p1"), "item 5"))]
    refused += [
        (T.models.variable_coefficient_3d(lambda x, y, z: 1.0 + x,
                                          finest_level=2, cycle=cyc),
         "halo3d_var"),
        (T.models.poisson3d_p2(finest_level=1, cycle=cyc), "halo3d_p2"),
        (T.models.poisson2d(finest_level=2, cycle=cyc), "item 14"),
    ]
    builders = (T.build_halo_solver3d, T.build_halo_mgcg3d,
                T.build_halo_resume3d)
    for cfg, item in refused:
        for build in builders:
            with pytest.raises(NotImplementedError, match=item):
                build(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        T.build_halo_cycler3d(refused[0][0], 2, device="cpu")


def test_slab_build_matches_jax(rank_results):
    """Each rank's b and g slabs (the port's distributed build) equal the
    JAX package's lean build padded in z by the port's plan
    (build_lean_hierarchy(cfg, pad_points=...)), cut by
    utils.convert.halo_slab_from_numpy, to 1e-12."""
    cfg, _ = _jax_cfg("rbgs")
    for P in SIZES:
        plan = ZPlan.of(ranks.config("rbgs"), P)
        jh = J.build_lean_hierarchy(cfg, pad_points=[
            None if z is None else (z, lm, lm)
            for z, lm in zip(plan.zs, plan.lms)])
        for rank in range(P):
            slabs = rank_results[rank][P]["slabs"]
            for li, lv in enumerate(jh.levels):
                for key in ("b", "g"):
                    want = halo_slab_from_numpy(np.asarray(getattr(lv, key)),
                                                plan, li, rank)
                    _close(slabs[key][li], want)


@pytest.mark.parametrize("P", SIZES)
def test_distributed_solves_match_jax(jhier, rank_results, P):
    """rbgs, Jacobi, Chebyshev, injection, MG-CG and the resumed solve
    over P ranks: the JAX single-device counts and histories, histories
    the same bits on every rank, u gathered bitwise the port's single-
    device u (MG-CG: 1e-12), resumed == uninterrupted bitwise."""
    runs = [rank_results[r][P] for r in range(P)]
    for name in ranks.CONFIGS:
        rec = runs[0][name]
        for other in runs[1:]:
            np.testing.assert_array_equal(other[name]["hist"], rec["hist"])
        jname = "rbgs" if name == "resume" else name
        jres = _jax_solve(jhier, jname)
        jk = int(jres.num_iters if name == "mgcg" else jres.num_cycles)
        k = rec["count"]
        assert k == jk, (name, P, k, jk)
        assert rec["converged"] == bool(jres.converged), (name, P)
        port, rn_ref = _port_solve(jname)
        np.testing.assert_allclose(rec["hist"][:k],
                                   np.asarray(jres.res_hist)[:k], rtol=RTOL,
                                   atol=1e-15 * rn_ref)
        assert np.isnan(rec["hist"][k:]).all()
        if name == "mgcg":
            _close(rec["u"], port.u.numpy())
        else:
            np.testing.assert_array_equal(rec["u"], port.u.numpy())
    np.testing.assert_array_equal(runs[0]["resume"]["u"], runs[0]["rbgs"]["u"])
    np.testing.assert_array_equal(runs[0]["resume"]["hist"],
                                  runs[0]["rbgs"]["hist"])


def test_distributed_entry_points(rank_results):
    """Over P in {2, 4} ranks: make_distributed_rb_smoother and
    _jacobi_smoother (K25, K26 twins, 2 sweeps) gathered == 2
    single-device sweeps bitwise; halo_extend_z gives each rank its
    neighbours' slabs (zeros past the edges); the cycler's 2 V-cycles from
    zero == the port's single-device vcycle twice, bitwise."""
    cfg = ranks.config("rbgs")
    h = T.build_lean_hierarchy(cfg, device="cpu")
    L = h.num_levels - 1
    lm = h.finest.n + 1
    wc, woff = tdispatch.const7_weights(h.finest.A)
    v, f = (torch.from_numpy(a) for a in ranks.entry_point_inputs(lm))
    rb, jac = v, v
    for _ in range(2):
        rb = s3.rb_sweep_ref(rb, f, lm, wc, woff)
        jac = s3.jacobi_sweep_ref(jac, f, lm, wc, woff, 2.0 / 3.0)
    u = torch.zeros_like(h.finest.b)
    for _ in range(2):
        u = T.vcycle(h, cfg.cycle, L, u, h.finest.b)
    for P in SIZES:
        got = rank_results[0][P]["entry_points"]
        np.testing.assert_array_equal(got["rb"], rb.numpy())
        np.testing.assert_array_equal(got["jacobi"], jac.numpy())
        np.testing.assert_array_equal(got["cycles"], u.numpy())
        plan = ZPlan.of(cfg, P)
        mz = plan.mz(L)
        vz = np.zeros((plan.zs[L] + 4, lm, lm))
        vz[2:2 + lm] = v.numpy()
        for r in range(P):
            np.testing.assert_array_equal(
                rank_results[r][P]["entry_points"]["extended"],
                vz[r * mz:r * mz + mz + 4])
