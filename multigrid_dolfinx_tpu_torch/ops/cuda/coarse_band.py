"""Coarsest-level Cholesky solve over the factor's band, K39: the block
layout, the CUDA wrapper and its plain version.

K39 coarse_band_solve replaces no TPU kernel: the JAX package leaves the
  coarse solve to XLA (cho_solve on the dense factor), and the port
  called torch.cholesky_solve, which copied the dense f64 factor on every
  call (1.95 GB at the 25^3 Galerkin coarsest level) before two trsv.
  Bound on the H100: the 4 nb - 2 dependent steps of the two sweeps (a
  grid barrier each) plus the packed blocks read once a solve (about
  8 nb (bs^2 + w^2) bytes).  Design in csrc/coarse_band.cu: one
  cooperative launch a solve, one warp a row of a step, a fixed halving
  tree a row sum.

The layout (`band_factor`, once, on the host): the lower factor L of the
n x n coarsest matrix has half-bandwidth w (a radius-1 stencil in
lexicographic order: 25^2 + 25 + 1 = 651 at 25^3).  Cut into nb blocks
of bs >= w rows (the last one padded by identity rows), L is block lower
bidiagonal: diagonal blocks D_k and blocks C_k below them, C_k nonzero
only at columns >= row + shift, shift = bs - w.  nb is the fewest blocks
of at most MAX_BLOCK rows, so the chain of steps is short, but at least
MIN_BLOCKS (block_layout): 16 of 977 rows at 25^3, 3 of 243 at 9^3.
Stored per block, f64, on the solve's device:
d[k] = tril(D_k^-1) + triu(D_k^-T, 1) and c[k-1] = triu(C_k) + tril(C_k^T,
-1).  Both sweeps read each of them once: forward the lower / upper
triangle, back the other one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .stencil3d import check_tensor, stream, suffix

#: Calls of the wrapper that launched its kernel.
LAUNCHES = {"coarse_band_solve": 0}

#: Most rows of a block: a warp's 32 lanes hold 32 columns each.
MAX_BLOCK = 1024
#: Fewest blocks where the band allows (block_layout).
MIN_BLOCKS = 3


@dataclasses.dataclass(frozen=True)
class BandFactor:
    """L's band in block form (module doc); d and c on the solve's
    device."""

    d: torch.Tensor       # (nb, bs, bs) f64
    c: torch.Tensor       # (nb - 1, bs, bs) f64
    n: int
    w: int
    nb: int
    bs: int

    @property
    def shift(self) -> int:
        return self.bs - self.w


def lower_bandwidth(L: np.ndarray, rows: int = 1024) -> int:
    """The largest i - j with L[i, j] != 0; raise if L is not square and
    lower triangular."""
    n = L.shape[0]
    if L.ndim != 2 or L.shape[1] != n:
        raise ValueError(f"the factor is not square: {L.shape}")
    w = 0
    cols = np.arange(n)
    for i0 in range(0, n, rows):
        nz = L[i0:i0 + rows] != 0
        # a column's first nonzero row in these rows lies on or below the
        # diagonal, and a row's first nonzero column at most w left of it
        if (nz.any(axis=0) & (i0 + nz.argmax(axis=0) < cols)).any():
            raise ValueError("the factor has entries above its diagonal")
        i = cols[i0:i0 + nz.shape[0]]
        w = max(w, int(np.where(nz.any(axis=1), i - nz.argmax(axis=1),
                                0).max()))
    return w


def block_layout(n: int, w: int):
    """(nb, bs): blocks of bs >= w rows (w >= 1), as few as the kernel's
    MAX_BLOCK rows allow, so the chain of steps is short, but at least
    MIN_BLOCKS where w allows, so the host's inverses of the diagonal
    blocks (n bs^2 / 3 flops) stay under a ninth of the dense Cholesky
    (n^3 / 3) that the build already pays."""
    nb = min(n // w, max(MIN_BLOCKS, -(-n // MAX_BLOCK)))
    bs = -(-n // nb)
    if not w <= bs <= MAX_BLOCK:
        raise ValueError(f"half-bandwidth {w} does not fit blocks of at "
                         f"most {MAX_BLOCK} rows (n={n})")
    return nb, bs


def band_factor(L: np.ndarray, device, w: Optional[int] = None
                ) -> BandFactor:
    """The block layout of the dense lower factor L, on `device`.  With w
    given (the stencil's half-bandwidth), an entry of L beyond it raises;
    else w is L's own."""
    from scipy.linalg import lapack

    L = np.asarray(L, dtype=np.float64)
    wl = lower_bandwidth(L)
    if w is not None and wl > w:
        raise ValueError(f"the factor has an entry {wl} below its diagonal, "
                         f"outside the band of half-width {w}")
    n = L.shape[0]
    w = max(wl, 1)
    nb, bs = block_layout(n, w)
    d = np.empty((nb, bs, bs))
    c = np.empty((nb - 1, bs, bs))
    for k in range(nb):
        r0, r1 = k * bs, min((k + 1) * bs, n)
        D = L[r0:r1, r0:r1]
        if r1 - r0 < bs:
            D = np.eye(bs)
            D[:r1 - r0, :r1 - r0] = L[r0:r1, r0:r1]
        # dtrtri leaves the zero upper triangle as it is
        Dinv, info = lapack.dtrtri(D, lower=1)
        if info != 0 or not np.isfinite(Dinv).all():
            raise ValueError(f"diagonal block {k} of the factor is singular")
        _pack(Dinv, d[k])
        if k:
            # upper triangular: L has nothing beyond w = bs - shift
            C = L[r0:r1, r0 - bs:r0]
            if r1 - r0 < bs:
                C = np.zeros((bs, bs))
                C[:r1 - r0] = L[r0:r1, r0 - bs:r0]
            _pack(C, c[k - 1])
    return BandFactor(d=torch.from_numpy(d).to(device),
                      c=torch.from_numpy(c).to(device), n=n, w=w, nb=nb,
                      bs=bs)


def _pack(T: np.ndarray, out: np.ndarray) -> None:
    """out = T + T^T with T's own diagonal: a triangular T and its
    transpose in one symmetric array."""
    np.add(T, T.T, out=out)
    np.fill_diagonal(out, np.diagonal(T))


def coarse_band_solve(f: torch.Tensor, band: BandFactor) -> torch.Tensor:
    """L L^T u = f in one launch: u flat, in f's dtype."""
    f = f.reshape(-1)
    check_tensor(f, "f", (band.n,))
    if band.d.device != f.device:
        raise ValueError(f"band on {band.d.device}, f on {f.device}")
    u = torch.empty_like(f)
    work = torch.empty(2 * band.nb * band.bs + band.bs, dtype=torch.float64,
                       device=f.device)
    fn = getattr(build.library(), f"mg_coarse_band_solve_{suffix(f.dtype)}")
    with torch.cuda.device(f.device):
        err = fn(f.data_ptr(), u.data_ptr(), band.d.data_ptr(),
                 band.c.data_ptr(), work.data_ptr(), band.n, band.nb,
                 band.bs, band.shift, stream(f))
    build.check(err, "coarse_band_solve")
    LAUNCHES["coarse_band_solve"] += 1
    return u


def _row_dots(m: torch.Tensor, v: torch.Tensor, lower: bool,
              diag: int) -> torch.Tensor:
    """Row sums of m * v over its lower (tril(diag)) or upper (triu(diag))
    part, +0.0 elsewhere, in the kernel's halving tree: column j + h onto
    j while j + h is inside the row, h = P/2 ... 1, P the power of two >=
    max(32, columns)."""
    def part(x, d):
        return x.tril_(d) if lower else x.triu_(d)

    w = m.shape[1]
    h = max(32, 1 << (w - 1).bit_length()) // 2
    if w > h:
        x = part(m[:, :h] * v[:h], diag)
        x[:, :w - h] += part(m[:, h:] * v[h:], diag - h)
        w = h
    else:
        x = part(m * v, diag)
    while h > 1:
        h //= 2
        if w > h:
            x[:, :w - h] += x[:, h:w]
            x, w = x[:, :h], h
    return x[:, 0]


def coarse_band_solve_ref(f: torch.Tensor, band: BandFactor) -> torch.Tensor:
    """Plain version of coarse_band_solve: the same block steps and sums
    in the same order, so the two agree bitwise."""
    n, nb, bs, shift = band.n, band.nb, band.bs, band.shift
    v = F.pad(f.reshape(-1).to(torch.float64), (0, nb * bs - n))
    v = v.view(nb, bs)
    y = [_row_dots(band.d[0], v[0], True, 0)]
    for k in range(1, nb):
        t = v[k] - _row_dots(band.c[k - 1], y[-1], False, shift)
        y.append(_row_dots(band.d[k], t, True, 0))
    x = [None] * nb
    for k in range(nb - 1, -1, -1):
        t = y[k] if k == nb - 1 else (
            y[k] - _row_dots(band.c[k], x[k + 1], True, -shift))
        x[k] = _row_dots(band.d[k], t, False, 0)
    return torch.cat(x)[:n].to(f.dtype)
