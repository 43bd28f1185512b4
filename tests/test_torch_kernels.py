"""The PyTorch port's kernels K1-K4 (plain versions) against the JAX package;
K1 and K4's z-marching plane schedules replayed on the CPU; K38's CPU
dispatch and its wrapper's refusal of CPU tensors (its twin meets the JAX
package in tests/test_torch_mass_quad.py).

Each CUDA kernel of `multigrid_dolfinx_tpu_torch/ops/cuda` has a plain
PyTorch version that the CPU path runs and that the card compares the
kernel with (chip_smoke.py).  Here each plain version meets the JAX
package's plain counterpart on the same numpy-seeded inputs, in f64:
tests/test_pallas_kernels.py already pins those counterparts to the
Pallas kernels.

Tolerance rtol 1e-12 (with atol 1e-12 of the reference's magnitude):
the port follows the Pallas kernels' association order, the JAX plain
path another (e.g. v + dinv (f - A v) against (f - woff S) / wc), so the
two agree to a few f64 ulps, not bitwise.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_dolfinx_tpu.config import CycleSpec as JCycleSpec
from multigrid_dolfinx_tpu.config import HierarchySpec as JHierarchySpec
from multigrid_dolfinx_tpu.config import ProblemSpec as JProblemSpec
from multigrid_dolfinx_tpu.config import SolverConfig as JSolverConfig
from multigrid_dolfinx_tpu.ops import dispatch as jdispatch
from multigrid_dolfinx_tpu.ops import transfer as jtransfer
from multigrid_dolfinx_tpu.ops.smoothers import multicolor_gs_smooth
from multigrid_dolfinx_tpu.solver.fmg import residual_norm as jresidual_norm
from multigrid_dolfinx_tpu.solver.hierarchy import \
    build_lean_hierarchy as jbuild_lean
from multigrid_dolfinx_tpu.solver.vcycle import (compute_residual,
                                                 prolong_level,
                                                 restrict_level)
from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
from multigrid_dolfinx_tpu_torch.ops import dispatch, transfer
from multigrid_dolfinx_tpu_torch.ops.cuda import build, stencil3d
from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_norm

torch.set_num_threads(1)

RTOL = 1e-12
CSRC = Path(build.CSRC_DIR)
AXIS7 = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1),
         (0, 1, 0), (1, 0, 0))


def _close(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


def _jax_lean(diagonal="right", finest_level=2):
    """JAX lean hierarchy on its plain path (use_pallas=False), f64:
    levels of 9^3, 17^3 and 33^3 nodes."""
    cyc = JCycleSpec(nu1=2, nu2=2, smoother="rbgs", restriction="pt")
    cfg = JSolverConfig(
        problem=JProblemSpec(ndim=3, rhs_const=-12.0, diagonal=diagonal),
        hierarchy=JHierarchySpec(coarsest_elements=8, coarsest_level=0,
                                 finest_level=finest_level),
        cycle=cyc, dtype="float64")
    return jbuild_lean(cfg)


@pytest.fixture(scope="module")
def jhier():
    return _jax_lean()


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


@pytest.mark.parametrize("lidx", [1, 2])
def test_rb_sweep_matches_jax_gs(jhier, lidx):
    """K1: one red-black sweep = the JAX multicolor GS for 1 sweep."""
    lv = jhier.levels[lidx]
    lm = lv.n + 1
    v, f = _inputs(10 + lidx, (lm,) * 3, (lm,) * 3)
    wc, woff = jdispatch.const7_weights(lv.A)
    ref = jax.jit(lambda vv, ff: multicolor_gs_smooth(lv.sm, lv.A, vv, ff, 1))(
        jnp.asarray(v), jnp.asarray(f))
    port = stencil3d.rb_sweep_ref(torch.from_numpy(v), torch.from_numpy(f),
                                  lm, wc, woff)
    _close(port, ref)
    # GS contract: boundary rows hold exactly f after the sweep
    inner = (slice(1, -1),) * 3
    bnd = np.ones((lm,) * 3, bool)
    bnd[inner] = False
    assert np.array_equal(port.numpy()[bnd], f[bnd])


@pytest.mark.parametrize("lidx", [1, 2])
def test_restrict_residual_pt_matches_jax_two_step(jhier, lidx):
    """K2: fused residual + P^T = compute_residual + restrict_level('pt')."""
    lv, lv_c = jhier.levels[lidx], jhier.levels[lidx - 1]
    lmf, lmc = lv.n + 1, lv_c.n + 1
    v, f = _inputs(20 + lidx, (lmf,) * 3, (lmf,) * 3)
    wc, woff = jdispatch.const7_weights(lv.A)
    ref = jax.jit(lambda vv, ff: restrict_level(
        compute_residual(lv, vv, ff), lv, lv_c, "pt"))(jnp.asarray(v),
                                                       jnp.asarray(f))
    port = stencil3d.restrict_residual_pt_ref(
        torch.from_numpy(v), torch.from_numpy(f), lmf, lmc, wc, woff)
    _close(port, ref)


@pytest.mark.parametrize("lidx", [1, 2])
@pytest.mark.parametrize("fused_add", [False, True])
def test_prolong_linear_matches_jax(jhier, lidx, fused_add):
    """K3: P(c) = prolong_level; with v, v + P(c) = v + prolong_level."""
    lv, lv_c = jhier.levels[lidx], jhier.levels[lidx - 1]
    lmf, lmc = lv.n + 1, lv_c.n + 1
    c, v = _inputs(30 + lidx, (lmc,) * 3, (lmf,) * 3)
    e = jax.jit(lambda cc: prolong_level(cc, lv_c, lv, "bilinear"))(
        jnp.asarray(c))
    ref = jnp.asarray(v) + e if fused_add else e
    port = stencil3d.prolong_linear_ref(
        torch.from_numpy(c), lmf, torch.from_numpy(v) if fused_add else None)
    _close(port, ref)


@pytest.mark.parametrize("diagonal", ["right", "left"])
def test_residual_tet_quad_matches_jax_mass_norm(jhier, diagonal):
    """K4: r^T M r = residual_norm(hier, compute_residual(...))^2."""
    h = jhier if diagonal == "right" else _jax_lean("left", finest_level=1)
    lv = h.finest
    lm = lv.n + 1
    v, f = _inputs(40, (lm,) * 3, (lm,) * 3)
    wc, woff = jdispatch.const7_weights(lv.A)
    rn = jax.jit(lambda vv, ff: jresidual_norm(
        h, compute_residual(lv, vv, ff)))(jnp.asarray(v), jnp.asarray(f))
    port = stencil3d_norm.residual_tet_quad_ref(
        torch.from_numpy(v), torch.from_numpy(f), lm, wc, woff, diagonal)
    assert port.dtype == torch.float64
    np.testing.assert_allclose(float(port), float(rn) ** 2, rtol=RTOL)


@pytest.mark.parametrize("lm", [9, 10])
def test_zmarch_plane_schedules_match_plain(lm):
    """K1 and K4's z-marching plane schedules, replayed on torch tensors in
    f64, give their plain versions.  K1: each z segment [za, zb) works on
    its own copy of v; step z updates red at plane z in place (za-1 <= z
    <= zb), then black at plane z-2 in place (za <= z-2 < zb), then stores
    plane z-3: bitwise rb_sweep_ref for every segment length.  K4: the
    cells summed plane pair by plane pair, within 1e-12 of
    residual_tet_quad_ref."""
    v, f = (torch.from_numpy(a) for a in _inputs(70 + lm, (lm,) * 3,
                                                  (lm,) * 3))
    wc, woff = 0.75, -0.125
    want = stencil3d.rb_sweep_ref(v, f, lm, wc, woff)
    for seg in (1, 3, lm):
        out = torch.full_like(v, float("nan"))
        for za in range(0, lm, seg):
            zb = min(za + seg, lm)
            ring = v.clone()
            for z in range(za - 1, zb + 3):
                if 0 <= z <= min(zb, lm - 1):
                    ring[z] = stencil3d.rb_half_sweep_ref(
                        ring, f, lm, wc, woff, 0)[z]
                if za <= z - 2 < zb:
                    ring[z - 2] = stencil3d.rb_half_sweep_ref(
                        ring, f, lm, wc, woff, 1)[z - 2]
                if za <= z - 3 < zb:
                    out[z - 3] = ring[z - 3]
        assert torch.equal(out, want), seg

    r = stencil3d.residual_ref(v, f, lm, wc, woff)
    nc = lm - 1
    for diagonal in ("right", "left"):
        tets, counts = stencil3d_norm.tet_tables(diagonal)
        q = torch.zeros((), dtype=torch.float64)
        for c in range(nc):
            pair = (r[c], r[c + 1])

            def corner(d):
                return pair[d[0]][d[1]:d[1] + nc, d[2]:d[2] + nc]

            acc = torch.zeros((nc, nc), dtype=v.dtype)
            for d, cnt in counts.items():
                acc = acc + float(cnt) * corner(d) * corner(d)
            for tet in tets:
                t = ((corner(tet[0]) + corner(tet[1])) + corner(tet[2])) + \
                    corner(tet[3])
                acc = acc + t * t
            q = q + torch.sum(acc, dtype=torch.float64)
        ref = stencil3d_norm.residual_tet_quad_ref(v, f, lm, wc, woff,
                                                   diagonal)
        np.testing.assert_allclose(float(q) * (1.0 / nc) ** 3 / 120.0,
                                   float(ref), rtol=1e-12)


def test_plain_transfers_match_jax():
    """The two-step plain transfers (ops/transfer.py) = the JAX ones."""
    c, r = _inputs(50, (9,) * 3, (17,) * 3)
    _close(transfer.prolong_linear(torch.from_numpy(c)),
           jax.jit(jtransfer.prolong_linear)(jnp.asarray(c)))
    _close(transfer.restrict_pt(torch.from_numpy(r)),
           jax.jit(jtransfer.restrict_pt)(jnp.asarray(r)))


def test_dispatch_takes_plain_version_on_cpu():
    """On CPU tensors the dispatch returns the plain version's result and
    launches nothing; the library is never built."""
    lm, lmc = 17, 9
    v, f, c = (torch.from_numpy(a) for a in _inputs(60, (lm,) * 3, (lm,) * 3,
                                                   (lmc,) * 3))
    wc, woff = 0.75, -0.125
    kcuda.reset_launch_counts()
    assert torch.equal(dispatch.rb_sweep(v, f, lm, wc, woff),
                       stencil3d.rb_sweep_ref(v, f, lm, wc, woff))
    assert torch.equal(
        dispatch.restrict_residual_pt(v, f, lm, lmc, wc, woff),
        stencil3d.restrict_residual_pt_ref(v, f, lm, lmc, wc, woff))
    assert torch.equal(dispatch.prolong_linear(c, lm, v),
                       stencil3d.prolong_linear_ref(c, lm, v))
    assert torch.equal(
        dispatch.residual_tet_quad(v, f, lm, wc, woff, "right"),
        stencil3d_norm.residual_tet_quad_ref(v, f, lm, wc, woff, "right"))
    tables = torch.ones((7, 27), dtype=v.dtype)
    assert torch.equal(
        dispatch.residual_mass_quad(v, f, tables, AXIS7, lm, wc, woff),
        stencil3d_norm.residual_mass_quad_ref(v, f, tables, AXIS7, lm, wc,
                                              woff))
    assert all(n == 0 for n in kcuda.launch_counts().values())
    assert build._LIB is None


@pytest.mark.parametrize("kernel", ["rb_sweep", "restrict_residual_pt",
                                    "prolong_linear", "residual_tet_quad",
                                    "residual_mass_quad"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """The wrappers launch only on CUDA tensors; a CPU tensor raises
    before anything is built."""
    v = torch.zeros((17,) * 3, dtype=torch.float32)
    c = torch.zeros((9,) * 3, dtype=torch.float32)
    calls = {
        "rb_sweep": lambda: stencil3d.rb_sweep(v, v, 17, 0.75, -0.125),
        "restrict_residual_pt": lambda: stencil3d.restrict_residual_pt(
            v, v, 17, 9, 0.75, -0.125),
        "prolong_linear": lambda: stencil3d.prolong_linear(c, 17, v),
        "residual_tet_quad": lambda: stencil3d_norm.residual_tet_quad(
            v, v, 17, 0.75, -0.125, "right"),
        "residual_mass_quad": lambda: stencil3d_norm.residual_mass_quad(
            v, v, torch.ones((7, 27)), AXIS7, 17, 0.75, -0.125),
    }
    with pytest.raises(ValueError, match="CUDA tensor"):
        calls[kernel]()
    assert build._LIB is None


def _cu_array(src, name):
    m = re.search(name + r"(\[\d+\])+\s*=\s*(\{.*?\});", src, re.S)
    return [int(x) for x in re.findall(r"-?\d+", m.group(2))]


@pytest.mark.parametrize("diagonal", ["right", "left"])
def test_cuda_tet_tables_match_simplex_offsets(diagonal):
    """K4's compile-time tet tables in stencil3d_norm.cu are the Kuhn tets
    of fem/assembly.py ('left' = bit 2 of each corner code flipped)."""
    src = (CSRC / "stencil3d_norm.cu").read_text()
    flip = 4 if diagonal == "left" else 0
    tets_cu = np.array(_cu_array(src, "tets")).reshape(6, 4) ^ flip
    corner_cu = np.array(_cu_array(src, "corner")) ^ flip
    count_cu = _cu_array(src, "count")
    tets, counts = stencil3d_norm.tet_tables(diagonal)

    def code(c):
        return c[0] * 4 + c[1] * 2 + c[2]

    assert tets_cu.tolist() == [[code(c) for c in t] for t in tets]
    assert corner_cu.tolist() == [code(c) for c in counts]
    assert count_cu == list(counts.values())


def test_build_flags_and_c_signatures():
    """The library is built for sm_90a without multiply-add contraction,
    keyed on the sources, and bound with the C prototypes' argument
    kinds."""
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--fmad=false" in build.NVCC_FLAGS
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libmg_torch_")
    srcs = "".join((CSRC / s).read_text() for s in build.SOURCES)
    for name, sig in build.SIGNATURES.items():
        # the ctypes argument kinds match the C prototype, one by one
        m = re.search(r"int " + name + r"\(([^)]*)\)", srcs)
        params = [p.strip() for p in m.group(1).split(",")]
        kinds = "".join("p" if "*" in p else p.split()[-2][0]
                        for p in params)
        assert kinds == sig, name
