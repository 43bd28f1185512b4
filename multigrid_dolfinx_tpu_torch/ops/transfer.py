"""Grid transfers as plain torch ops, in 2D and 3D.

`restrict_inject` is the reference's injection (coarse[p] = fine[2p]),
`restrict_pt` the variational P^T (2^d times the reference's full
weighting) and `prolong_linear` the multilinear interpolation, each in
the association order of `multigrid_dolfinx_tpu.ops.transfer`.  The
V-cycle runs injection from here and the kernels for the rest
(ops.cuda); the plain two-step forms are what the W/F cycles of
ROADMAP.md queue 1, item 8 will use.  Full weighting as a cycle option
and the P1 embedding are queue 1, item 5.
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


def restrict(u_fine: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "injection":
        return restrict_inject(u_fine)
    if kind == "pt":
        return restrict_pt(u_fine)
    raise NotImplementedError(
        f"restriction {kind!r} is ROADMAP.md queue 1, item 5")


def prolong(u_coarse: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "bilinear":
        return prolong_linear(u_coarse)
    raise NotImplementedError(
        f"prolongation {kind!r} is ROADMAP.md queue 1, item 5")
