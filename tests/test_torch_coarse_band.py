"""The coarsest-level banded Cholesky solve (ops/cuda/coarse_band.py): its
block layout and its plain version, which the CPU path runs and which
kernel K39 matches bitwise on the card (chip_smoke.py phase 33).  CPU
only, f64, tiny grids; builds nothing of the JAX package."""
import numpy as np
import pytest
import torch

import multigrid_dolfinx_tpu_torch as T
from multigrid_dolfinx_tpu_torch.ops import dispatch
from multigrid_dolfinx_tpu_torch.ops.coarse import coarse_solver_from_numpy
from multigrid_dolfinx_tpu_torch.ops.cuda import coarse_band as cb

torch.set_num_threads(1)

CYC = T.CycleSpec(nu1=2, nu2=2, smoother="rbgs", restriction="pt", tol=0.0,
                  rtol=1e-8, max_cycles=40, track_error=False)


def _coarse(case):
    """The coarsest level's solver of a tiny hierarchy, and its half-
    bandwidth in lexicographic order."""
    if case == "p1_3d":        # 9^3, 7-point: w = 9^2
        cfg = T.models.poisson3d(finest_level=1, coarsest_level=0,
                                 coarsest_elements=8, dtype="float64",
                                 cycle=CYC)
        return T.build_lean_hierarchy(cfg, device="cpu").coarse, 81
    if case == "galerkin_3d":  # 9^3, 27-point: w = 9^2 + 9 + 1
        cfg = T.models.variable_coefficient_3d(
            lambda x, y, z: 1.0 + x + 2.0 * y + z, finest_level=1,
            coarsest_level=0, coarsest_elements=8, dtype="float64",
            cycle=CYC)
        return T.build_var_hierarchy(cfg, device="cpu").coarse, 91
    if case == "p1_2d":        # 9^2, 5-point: w = 9
        cfg = T.models.poisson2d(finest_level=1, coarsest_level=0,
                                 coarsest_elements=8, dtype="float64",
                                 cycle=CYC)
        return T.build_lean_hierarchy(cfg, device="cpu").coarse, 9
    # the P2 coarsest lattice, 9^3, radius 2: w = 2 (9^2 + 9) + 2 minus the
    # offsets Kuhn's P2 stencil does not have
    cyc = T.CycleSpec(nu1=2, nu2=2, smoother="jacobi", restriction="pt",
                      tol=0.0, rtol=1e-10, max_cycles=40, track_error=False)
    cfg = T.models.poisson3d_p2(finest_level=1, coarsest_level=0,
                                coarsest_elements=4, dtype="float64",
                                cycle=cyc)
    return T.build_p2_hierarchy(cfg, device="cpu").coarse, 172


def _rel(u, ref):
    return float((u - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("blocks", ["default", "one", "small"])
@pytest.mark.parametrize("case", ["p1_3d", "galerkin_3d", "p1_2d", "p2_3d"])
def test_band_solve_matches_cholesky_solve(case, blocks, monkeypatch):
    """The plain banded solve = torch.cholesky_solve on the dense factor to
    1e-12 relative (max norm): in the layout the card gets, in one block
    and in blocks of at most 2 w + 1 rows (more steps, the C blocks and
    their shift)."""
    solver, w = _coarse(case)
    if blocks == "one":
        monkeypatch.setattr(cb, "MIN_BLOCKS", 1)
    elif blocks == "small":
        monkeypatch.setattr(cb, "MAX_BLOCK", 2 * w + 1)
    solver = coarse_solver_from_numpy(solver.factor.numpy(), None,
                                      "cholesky", solver.grid_shape, "cpu", w)
    band = solver.band
    n, nb, bs = band.n, band.nb, band.bs
    assert band.w == w and w <= bs <= cb.MAX_BLOCK
    assert (nb - 1) * bs < n <= nb * bs
    assert nb == {"default": min(3, n // w), "one": 1,
                  "small": max(3, -(-n // (2 * w + 1)))}[blocks]
    f = torch.from_numpy(np.random.default_rng(3).standard_normal(
        solver.grid_shape))
    ref = torch.cholesky_solve(f.reshape(-1, 1), solver.factor,
                               upper=False).reshape(solver.grid_shape)
    u = solver.solve(f)
    assert u.shape == f.shape and u.dtype == torch.float64
    assert _rel(u, ref) < 1e-12


def test_layout_of_a_dense_factor(monkeypatch):
    """w and the blocks as computed from a dense factor (the numpy path,
    which has no stencil): each packed block holds D_k^-1 below its
    diagonal and D_k^-T above it, C_k above and C_k^T below; a factor with
    an entry outside its stencil's band, or above its diagonal, raises."""
    monkeypatch.setattr(cb, "MAX_BLOCK", 100)
    solver, w = _coarse("p1_3d")
    L = solver.factor.numpy()
    band = coarse_solver_from_numpy(L, None, "cholesky", (9, 9, 9),
                                    "cpu").band
    assert cb.lower_bandwidth(L) == w == band.w
    assert (band.nb, band.bs, band.shift) == (8, 92, 11)
    assert band.d.shape == (8, 92, 92) and band.c.shape == (7, 92, 92)
    for k in range(band.nb):
        r0, r1 = 92 * k, min(92 * (k + 1), 729)
        D = np.eye(92)
        D[:r1 - r0, :r1 - r0] = L[r0:r1, r0:r1]
        dk = band.d[k].numpy()
        np.testing.assert_array_equal(dk, dk.T)
        np.testing.assert_allclose(np.tril(dk) @ D, np.eye(92), atol=1e-13)
        if k:
            C = np.zeros((92, 92))
            C[:r1 - r0] = L[r0:r1, r0 - 92:r0]
            ck = band.c[k - 1].numpy()
            np.testing.assert_array_equal(np.triu(ck), C)
            np.testing.assert_array_equal(np.tril(ck, -1), np.tril(C.T, -1))
            assert not np.tril(C, band.shift - 1).any()
    np.testing.assert_array_equal(band.d.numpy(), solver.band.d.numpy())
    bad = L.copy()
    bad[500, 500 - w - 1] = 1e-3
    with pytest.raises(ValueError, match="outside the band"):
        coarse_solver_from_numpy(bad, None, "cholesky", (9, 9, 9), "cpu", w)
    assert coarse_solver_from_numpy(bad, None, "cholesky", (9, 9, 9),
                                    "cpu").band.w == w + 1
    bad = L.copy()
    bad[10, 20] = 1.0
    with pytest.raises(ValueError, match="above its diagonal"):
        coarse_solver_from_numpy(bad, None, "cholesky", (9, 9, 9), "cpu")


def test_row_sums_follow_the_kernels_tree():
    """Each row sum is the halving tree the kernel runs (column j + h onto
    j while j + h is inside the row, in registers from h = P/2, then by
    shuffles), masked products +0.0: checked bitwise against the tree
    written out one element at a time."""
    rng = np.random.default_rng(5)
    for cols in (1, 7, 32, 33, 81, 100, 729):
        m = torch.from_numpy(rng.standard_normal((cols, cols)))
        v = torch.from_numpy(rng.standard_normal(cols))
        for lower, diag in ((True, 0), (False, 0), (True, -3), (False, 3)):
            got = cb._row_dots(m, v, lower, diag)
            for r in range(0, cols, max(1, cols // 7)):
                p = [float(m[r, j]) * float(v[j])
                     if (j <= r + diag if lower else j >= r + diag) else 0.0
                     for j in range(cols)]
                w, h = cols, max(32, 1 << (cols - 1).bit_length())
                while h > 1:
                    h //= 2
                    for j in range(min(h, w - h) if w > h else 0):
                        p[j] = p[j] + p[j + h]
                    w = min(w, h)
                assert float(got[r]) == p[0], (cols, lower, diag, r)


def test_solve_dtypes_and_route(monkeypatch):
    """f32 and f64 right-hand sides give their dtype back (f32 = the f64
    solve rounded); the CPU route never calls torch.cholesky_solve; the
    dense factor stays on the host."""
    solver, _ = _coarse("galerkin_3d")
    assert solver.factor.device.type == "cpu"

    def refuse(*a, **k):
        raise AssertionError("cholesky_solve called")

    monkeypatch.setattr(torch, "cholesky_solve", refuse)
    f = torch.from_numpy(np.random.default_rng(4).standard_normal(
        solver.grid_shape))
    u64 = solver.solve(f)
    u32 = solver.solve(f.float())
    assert u64.dtype == torch.float64 and u32.dtype == torch.float32
    assert torch.equal(u32, solver.solve(f.float().double()).float())
    assert torch.equal(u64, dispatch.coarse_band_solve(
        f, solver.band).reshape(f.shape))
    with pytest.raises(ValueError):
        cb.block_layout(2000, 1500)
