"""Const-7-point kernels K25-K29 on a z-slab of a distributed level: CUDA
wrappers and plain versions.

A rank's block is (mz, lm, lm), contiguous, unpadded in y and x; its
global z starts at z_base, and rows at global z >= lm are plan padding
(written as 0).  The z-neighbours' slabs come as separate (h, lm, lm)
arrays: `lo` the -z neighbour's top h slabs, `hi` the +z neighbour's
bottom h slabs, zeros at the domain edge.  Each `name(...)` launches the
hand-written Hopper kernel of `csrc/stencil3d_dist.cu` on CUDA tensors
(and raises on anything else); each `name_ref(...)` is its plain PyTorch
version, which concatenates the halos (the kernels read them through a
window instead) and keeps the kernel's association order.  Stitched over
the ranks, each equals the single-device kernel (K1, K11, K10, K2, K3) on
the global array bitwise.

K25 rb_sweep_dist replaces multigrid_dolfinx_tpu/ops/pallas/
  stencil3d_dist.py rb_sweep_fused_dist (2-deep halos).  Design: K1's two
  launches; the red launch covers the block and one halo slab each side
  (the halo slabs' red values go to a 2-slab scratch), the black launch
  updates the block in place from the red values.  Bound: memory, v, f
  and out once, as K1.  K25-K27 and K29 run one thread per point in
  K10's 32 x 8 blocks, one z plane per grid slice.
K26 jacobi_sweep_dist replaces jacobi_sweep_dist (1-deep halos): K11's
  (1-w) v + w cand, one thread per point, out of place.
K27 residual_dist replaces residual_dist (1-deep halos): K10's
  r = f - A v, boundary rows f - v.
K28 restrict_residual_pt_dist replaces restrict_residual_pt_dist (2-deep
  halos): K2's fused residual + P^T, one thread per coarse point in K2's
  1D blocks, the 27 residuals recomputed; two launches, the two end rows
  through the window and the inner rows on the block alone (K2's
  registers; a window in every thread took 165); z_base must be even
  (the plan's 4 ngz quantum makes it so), the coarse block starting at
  global z_base / 2.
K29 prolong_linear_dist replaces prolong_linear_add_dist: K3's trilinear
  prolongation of the local coarse block onto the fine block (2 mzc
  slabs), interpolating the top fine pair towards `chi`, the +z
  neighbour's first coarse slab; fused with the correction v + P(c) when
  v is given (the JAX kernel always takes v).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .stencil3d import (check_tensor, combine121, interp_axis, nbr_sum_ref,
                        stream, suffix)

#: Calls of each wrapper that launched its kernel(s) (rb_sweep_dist is two
#: launches per call).  Reset with ops.cuda.reset_launch_counts().
LAUNCHES = {"rb_sweep_dist": 0, "jacobi_sweep_dist": 0, "residual_dist": 0,
            "restrict_residual_pt_dist": 0, "prolong_linear_dist": 0}


def slab_coords(mz: int, lm: int, z0: int, device):
    """Global (z, y, x) index views of a (mz, lm, lm) block whose slab 0
    lies at global z0."""
    z = (torch.arange(mz, device=device) + z0).view(-1, 1, 1)
    i = torch.arange(lm, device=device)
    return z, i.view(1, -1, 1), i.view(1, 1, -1)


def slab_interior(mz: int, lm: int, z0: int, device) -> torch.Tensor:
    """Interior mask (1 <= index <= lm-2 on every axis, z global) of a
    (mz, lm, lm) block whose slab 0 lies at global z0."""
    z, y, x = slab_coords(mz, lm, z0, device)

    def inside(i):
        return (i >= 1) & (i <= lm - 2)

    return (inside(z) & inside(y) & inside(x)).expand(mz, lm, lm)


def inbox(mz: int, lm: int, z0: int, device) -> torch.Tensor:
    """(mz, 1, 1) mask of the slabs at global z <= lm - 1."""
    return slab_coords(mz, lm, z0, device)[0] <= lm - 1


def _check_block(v, f, halos, h, lm, name):
    mz = v.shape[0]
    check_tensor(v, f"{name} v", (mz, lm, lm))
    check_tensor(f, f"{name} f", (mz, lm, lm), v.dtype)
    for label, t in zip(("vlo", "vhi", "flo", "fhi"), halos):
        check_tensor(t, f"{name} {label}", (h, lm, lm), v.dtype)
    if mz < 1:
        raise ValueError(f"{name}: empty block")
    return mz


def _launch(name, fn, *args):
    build.check(fn(*args), name)
    LAUNCHES[name] += 1


def _extended(v, f, vlo, vhi, flo, fhi):
    return torch.cat([vlo, v, vhi]), torch.cat([flo, f, fhi])


# ----------------------------------------------------------------------
# K25: red-black Gauss-Seidel sweep on a slab
# ----------------------------------------------------------------------

def rb_sweep_dist(v, f, vlo, vhi, flo, fhi, lm: int, wc: float, woff: float,
                  z_base: int) -> torch.Tensor:
    """One full red-black GS sweep of the block with 2-deep halos."""
    mz = _check_block(v, f, (vlo, vhi, flo, fhi), 2, lm, "rb_sweep_dist")
    out = torch.empty_like(v)
    scratch = torch.empty((2, lm, lm), dtype=v.dtype, device=v.device)
    fn = getattr(build.library(), f"mg_rb_sweep_dist_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        _launch("rb_sweep_dist", fn, v.data_ptr(), f.data_ptr(),
                vlo.data_ptr(), vhi.data_ptr(), flo.data_ptr(),
                fhi.data_ptr(), out.data_ptr(), scratch.data_ptr(), mz, lm,
                z_base, 1.0 / wc, -woff, stream(v))
    return out


def rb_sweep_dist_ref(v, f, vlo, vhi, flo, fhi, lm: int, wc: float,
                      woff: float, z_base: int) -> torch.Tensor:
    """Plain version of rb_sweep_dist: K1's plain sweep on the block
    extended by its halos (global z from z_base - 2), cropped, padding
    rows 0."""
    mz = v.shape[0]
    ve, fe = _extended(v, f, vlo, vhi, flo, fhi)
    z0 = z_base - 2
    interior = slab_interior(mz + 4, lm, z0, v.device)
    z, y, x = slab_coords(mz + 4, lm, z0, v.device)
    parity = (z + y + x) % 2
    cur = ve
    for color in (0, 1):
        vt = torch.where(interior, cur, 0.0)
        cand = torch.where(interior,
                           (fe + (-woff) * nbr_sum_ref(vt)) * (1.0 / wc), fe)
        cur = torch.where(parity == color, cand, cur)
    return torch.where(inbox(mz, lm, z_base, v.device), cur[2:-2], 0.0)


# ----------------------------------------------------------------------
# K26: weighted Jacobi sweep on a slab
# ----------------------------------------------------------------------

def jacobi_sweep_dist(v, f, vlo, vhi, flo, fhi, lm: int, wc: float,
                      woff: float, w: float, z_base: int) -> torch.Tensor:
    """One weighted-Jacobi sweep of the block with 1-deep halos, into a
    fresh tensor."""
    mz = _check_block(v, f, (vlo, vhi, flo, fhi), 1, lm, "jacobi_sweep_dist")
    out = torch.empty_like(v)
    fn = getattr(build.library(), f"mg_jacobi_sweep_dist_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        _launch("jacobi_sweep_dist", fn, v.data_ptr(), f.data_ptr(),
                vlo.data_ptr(), vhi.data_ptr(), flo.data_ptr(),
                fhi.data_ptr(), out.data_ptr(), mz, lm, z_base, 1.0 / wc,
                -woff, 1.0 - w, w, stream(v))
    return out


def jacobi_sweep_dist_ref(v, f, vlo, vhi, flo, fhi, lm: int, wc: float,
                          woff: float, w: float,
                          z_base: int) -> torch.Tensor:
    """Plain version of jacobi_sweep_dist: (1-w) v + w cand, cand K1's
    candidate, on the halo-extended block, cropped, padding rows 0."""
    mz = v.shape[0]
    ve, fe = _extended(v, f, vlo, vhi, flo, fhi)
    interior = slab_interior(mz + 2, lm, z_base - 1, v.device)
    vt = torch.where(interior, ve, 0.0)
    cand = torch.where(interior,
                       (fe + (-woff) * nbr_sum_ref(vt)) * (1.0 / wc), fe)
    out = ((1.0 - w) * ve + w * cand)[1:-1]
    return torch.where(inbox(mz, lm, z_base, v.device), out, 0.0)


# ----------------------------------------------------------------------
# K27: residual on a slab
# ----------------------------------------------------------------------

def residual_dist(v, f, vlo, vhi, flo, fhi, lm: int, wc: float, woff: float,
                  z_base: int) -> torch.Tensor:
    """r = f - A v of the block with 1-deep halos, into a fresh tensor."""
    mz = _check_block(v, f, (vlo, vhi, flo, fhi), 1, lm, "residual_dist")
    out = torch.empty_like(v)
    fn = getattr(build.library(), f"mg_residual_dist_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        _launch("residual_dist", fn, v.data_ptr(), f.data_ptr(),
                vlo.data_ptr(), vhi.data_ptr(), flo.data_ptr(),
                fhi.data_ptr(), out.data_ptr(), mz, lm, z_base, wc, woff,
                stream(v))
    return out


def residual_dist_ref(v, f, vlo, vhi, flo, fhi, lm: int, wc: float,
                      woff: float, z_base: int) -> torch.Tensor:
    """Plain version of residual_dist: f - where(interior, wc v~ +
    woff S(v~), v) on the halo-extended block, cropped, padding rows 0."""
    mz = v.shape[0]
    ve, fe = _extended(v, f, vlo, vhi, flo, fhi)
    interior = slab_interior(mz + 2, lm, z_base - 1, v.device)
    vt = torch.where(interior, ve, 0.0)
    r = (fe - torch.where(interior, wc * vt + woff * nbr_sum_ref(vt),
                          ve))[1:-1]
    return torch.where(inbox(mz, lm, z_base, v.device), r, 0.0)


# ----------------------------------------------------------------------
# K28: fused residual + P^T restriction on a slab
# ----------------------------------------------------------------------

def _check_even(mz: int, z_base: int, name: str) -> None:
    if mz % 2 or z_base % 2:
        raise ValueError(f"{name}: the block ({mz} slabs at z {z_base}) "
                         "must start at an even z and hold an even count")


def restrict_residual_pt_dist(v, f, vlo, vhi, flo, fhi, lmf: int, lmc: int,
                              wc: float, woff: float,
                              z_base: int) -> torch.Tensor:
    """The local coarse block (mz/2, lmc, lmc) of P^T (f - A v), from the
    fine block with 2-deep halos."""
    mz = _check_block(v, f, (vlo, vhi, flo, fhi), 2, lmf,
                      "restrict_residual_pt_dist")
    _check_even(mz, z_base, "restrict_residual_pt_dist")
    if lmf != 2 * lmc - 1:
        raise ValueError(f"lmf={lmf} is not 2*lmc-1 for lmc={lmc}")
    out = torch.empty((mz // 2, lmc, lmc), dtype=v.dtype, device=v.device)
    fn = getattr(build.library(),
                 f"mg_restrict_residual_pt_dist_{suffix(v.dtype)}")
    with torch.cuda.device(v.device):
        _launch("restrict_residual_pt_dist", fn, v.data_ptr(), f.data_ptr(),
                vlo.data_ptr(), vhi.data_ptr(), flo.data_ptr(),
                fhi.data_ptr(), out.data_ptr(), mz, lmf, lmc, z_base, wc,
                woff, stream(v))
    return out


def restrict_residual_pt_dist_ref(v, f, vlo, vhi, flo, fhi, lmf: int,
                                  lmc: int, wc: float, woff: float,
                                  z_base: int) -> torch.Tensor:
    """Plain version of restrict_residual_pt_dist: the masked residual of
    local z -1 .. mz (from the 2-deep extended block), zero-padded in y
    and x, [1 2 1] combined along z, then y, then x, times 0.125, the
    coarse boundary (global coarse z from z_base / 2) zeroed."""
    mz = v.shape[0]
    _check_even(mz, z_base, "restrict_residual_pt_dist")
    ve, fe = _extended(v, f, vlo, vhi, flo, fhi)
    interior = slab_interior(mz + 4, lmf, z_base - 2, v.device)
    vt = torch.where(interior, ve, 0.0)
    r = torch.where(interior, fe - (wc * vt + woff * nbr_sum_ref(vt)), 0.0)
    g = torch.nn.functional.pad(r[1:-1], (1, 1, 1, 1))
    for axis in range(3):
        g = combine121(g, axis)
    if g.shape[1] != lmc:
        raise ValueError(f"lmc={lmc} does not match fine lm {lmf}")
    mask = slab_interior(mz // 2, lmc, z_base // 2, v.device)
    return torch.where(mask, g * 0.125, 0.0)


# ----------------------------------------------------------------------
# K29: trilinear prolongation (+ fused correction) on a slab
# ----------------------------------------------------------------------

def prolong_linear_dist(c, chi, lmf: int, z_base: int,
                        v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P(c) on the local fine block (2 mzc, lmf, lmf), or v + P(c) when v
    is given; chi is the +z neighbour's first coarse slab (1, lmc, lmc)."""
    mzc, lmc = c.shape[0], c.shape[1]
    if lmf != 2 * lmc - 1:
        raise ValueError(f"lmf={lmf} is not 2*lmc-1 for lmc={lmc}")
    _check_even(2 * mzc, z_base, "prolong_linear_dist")
    check_tensor(c, "prolong_linear_dist c", (mzc, lmc, lmc))
    check_tensor(chi, "prolong_linear_dist chi", (1, lmc, lmc), c.dtype)
    if mzc < 1:
        raise ValueError("prolong_linear_dist: empty block")
    if v is not None:
        check_tensor(v, "prolong_linear_dist v", (2 * mzc, lmf, lmf),
                     c.dtype)
    out = torch.empty((2 * mzc, lmf, lmf), dtype=c.dtype, device=c.device)
    fn = getattr(build.library(), f"mg_prolong_linear_dist_{suffix(c.dtype)}")
    with torch.cuda.device(c.device):
        _launch("prolong_linear_dist", fn, c.data_ptr(), chi.data_ptr(),
                None if v is None else v.data_ptr(), out.data_ptr(), mzc,
                lmc, lmf, z_base, stream(c))
    return out


def prolong_linear_dist_ref(c, chi, lmf: int, z_base: int,
                            v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of prolong_linear_dist: K3's plain interpolation (x,
    then y, then z) of the block extended by chi, cropped to 2 mzc fine
    slabs, rows at global z > lmf - 1 zero."""
    mzc = c.shape[0]
    e = interp_axis(interp_axis(interp_axis(torch.cat([c, chi]), 2), 1), 0)
    if e.shape[1] != lmf:
        raise ValueError(f"lmf={lmf} does not match coarse {tuple(c.shape)}")
    e = torch.where(inbox(2 * mzc, lmf, z_base, c.device), e[:2 * mzc], 0.0)
    return e if v is None else v + e
