"""Grid transfers as plain torch ops, in 2D and 3D.

`restrict_inject` is the reference's injection (coarse[p] = fine[2p]),
`restrict_full_weighting` the reference's full weighting (constant 1/4^d,
missing neighbours zero, PARITY.md section 2a), `restrict_pt` the
variational P^T (2^d times full weighting), `prolong_linear` the
multilinear interpolation and `prolong_p1` the exact P1 embedding, each
in the association order of `multigrid_dolfinx_tpu.ops.transfer`.  The
JAX package has no Pallas kernel for injection, full weighting or the P1
embedding, so the cycle runs them from here and the kernels for the rest
(ops.cuda).
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F


def restrict_inject(u_fine: torch.Tensor) -> torch.Tensor:
    """Coarse[p] = Fine[2p] (pure injection), contiguous."""
    return u_fine[(slice(None, None, 2),) * u_fine.ndim].contiguous()


def prolong_linear(u_coarse: torch.Tensor) -> torch.Tensor:
    """Multilinear interpolation coarse -> fine: each fine parity class is
    the mean of the 2^(#odd axes) surrounding coarse nodes."""
    d = u_coarse.ndim
    fine_shape = tuple(2 * (s - 1) + 1 for s in u_coarse.shape)
    out = torch.zeros(fine_shape, dtype=u_coarse.dtype, device=u_coarse.device)
    for parity in itertools.product((0, 1), repeat=d):
        corners = []
        choice = [range(2) if p else range(1) for p in parity]
        for corner in itertools.product(*choice):
            sl = tuple(
                slice(None) if p == 0
                else (slice(0, -1) if c == 0 else slice(1, None))
                for p, c in zip(parity, corner))
            corners.append(u_coarse[sl])
        avg = corners[0]
        for t in corners[1:]:
            avg = avg + t
        out[tuple(slice(p, None, 2) for p in parity)] = avg / len(corners)
    return out


def restrict_full_weighting(u_fine: torch.Tensor) -> torch.Tensor:
    """Tensor-product [1 2 1] weighting, missing neighbours count as zero,
    constant 1/4^d scaling, sampled at even indices."""
    d = u_fine.ndim
    up = F.pad(u_fine, (1, 1) * d)
    acc = None
    for off in itertools.product((-1, 0, 1), repeat=d):
        w = 1.0
        for o in off:
            w *= 2.0 if o == 0 else 1.0
        sl = tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, u_fine.shape))
        term = w * up[sl]
        acc = term if acc is None else acc + term
    acc = acc / (4.0 ** d)
    return acc[(slice(None, None, 2),) * d]


def restrict_pt(u_fine: torch.Tensor) -> torch.Tensor:
    """Variational restriction P^T = 2^d * full weighting."""
    return (2.0 ** u_fine.ndim) * restrict_full_weighting(u_fine)


def prolong_p1(u_coarse: torch.Tensor, diagonal: str = "right") -> torch.Tensor:
    """Exact P1 nested-space embedding on the triangulated grid: every fine
    node lies on a coarse mesh edge and takes the mean of its two
    endpoints.  2D: the (odd, odd) node on the triangle diagonal; 3D
    (Kuhn): the face-diagonal classes on the increasing diagonals and the
    (1,1,1) class on the main diagonal, mirrored in axis 0 for 'left'
    (the JAX package's transfer.prolong_p1, axis for axis)."""
    c = u_coarse
    m = c.shape[0]
    out = torch.zeros((2 * m - 1,) * c.ndim, dtype=c.dtype, device=c.device)
    ev, od = slice(None, None, 2), slice(1, None, 2)
    lo, hi, al = slice(None, -1), slice(1, None), slice(None)
    if c.ndim == 2:
        out[ev, ev] = c
        out[od, ev] = 0.5 * (c[lo, :] + c[hi, :])
        out[ev, od] = 0.5 * (c[:, lo] + c[:, hi])
        if diagonal == "right":
            out[od, od] = 0.5 * (c[lo, lo] + c[hi, hi])
        else:
            out[od, od] = 0.5 * (c[hi, lo] + c[lo, hi])
        return out
    if c.ndim != 3:
        raise NotImplementedError("p1 prolongation is 2D and 3D")
    out[ev, ev, ev] = c
    out[od, ev, ev] = 0.5 * (c[lo, al, al] + c[hi, al, al])
    out[ev, od, ev] = 0.5 * (c[al, lo, al] + c[al, hi, al])
    out[ev, ev, od] = 0.5 * (c[al, al, lo] + c[al, al, hi])
    yz = 0.5 * (c[al, lo, lo] + c[al, hi, hi])
    if diagonal == "right":
        xy = 0.5 * (c[lo, lo, al] + c[hi, hi, al])
        xz = 0.5 * (c[lo, al, lo] + c[hi, al, hi])
        ctr = 0.5 * (c[lo, lo, lo] + c[hi, hi, hi])
    else:
        xy = 0.5 * (c[hi, lo, al] + c[lo, hi, al])
        xz = 0.5 * (c[hi, al, lo] + c[lo, al, hi])
        ctr = 0.5 * (c[hi, lo, lo] + c[lo, hi, hi])
    out[od, od, ev] = xy
    out[od, ev, od] = xz
    out[ev, od, od] = yz
    out[od, od, od] = ctr
    return out


def restrict(u_fine: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "injection":
        return restrict_inject(u_fine)
    if kind == "full_weighting":
        return restrict_full_weighting(u_fine)
    if kind == "pt":
        return restrict_pt(u_fine)
    raise ValueError(f"unknown restriction {kind!r}")


def prolong(u_coarse: torch.Tensor, kind: str,
            diagonal: str = "right") -> torch.Tensor:
    if kind == "bilinear":
        return prolong_linear(u_coarse)
    if kind == "p1":
        return prolong_p1(u_coarse, diagonal)
    raise ValueError(f"unknown prolongation {kind!r}")
