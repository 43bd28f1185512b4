"""Plane-free P2 kernels K19-K21: CUDA wrappers and plain versions.

The operator is a (K, 64) parity table in the working type on the lm^3
half-step lattice (ops.operators, parity mode): the weight of offset k at
node p is tables[k][class(p)].  Each `name(...)` launches the hand-written
Hopper kernel of `csrc/stencil3d_p2.cu` on CUDA tensors (and raises on
anything else); each `name_ref(...)` is its plain PyTorch version with the
same association order, which the CPU path and the on-card comparison
use.

K19 p2_residual replaces multigrid_dolfinx_tpu/ops/pallas/stencil3d_p2.py
  p2_residual: r = f - A v on the Dirichlet-eliminated stiffness, reads
  interior-masked, boundary rows f - v.
K20 p2_jacobi_sweep replaces stencil3d_p2.py p2_jacobi_sweep: (1-w) v +
  (w d) (f - sum_{k != c}) on interior rows, d = 1/w_c of the parity
  class (1 where w_c = 0); boundary rows snap to f.  Out of place into a
  caller-given buffer.
K21 p2_mass_quad replaces stencil3d_p2.py p2_mass_quad: q = r^T M r for
  the raw P2 mass, every node of the box with its true 4^3 class (face
  rows included), reads inside the box; per-node values in the working
  type, summed in f64 through fixed per-block partials and a fixed-order
  second pass (the same sum on every run).  With r = b it is ||b||_M^2
  exactly, so the JAX package's shell delta and rn_ref precompute are
  not needed.
Bound on the H100: memory (K19/K20: v, f and the output, 0.48 ms at 513^3
f32; K21: r once, 0.16 ms; the nonzero weights' operations take less).
Design notes in the CUDA source.
"""
from __future__ import annotations

import functools
import itertools
from typing import Optional

import torch
import torch.nn.functional as F

from . import build
from .stencil3d import check_lm, check_tensor, stream, suffix
from ..operators import box_interior_mask, parity_gather

#: Calls of each wrapper that launched its kernel (p2_mass_quad is two
#: launches a call).  Reset with ops.cuda.reset_launch_counts().
LAUNCHES = {"p2_residual": 0, "p2_jacobi_sweep": 0, "p2_mass_quad": 0}

#: Most offsets the kernels take (csrc/stencil3d_p2.cu kMaxOffsets).
MAX_OFFSETS = 72
#: K21's reduction shape (csrc/stencil3d_p2.cu): threads a block, most
#: blocks, threads of the second pass.
QUAD_THREADS = 256
QUAD_MAX_BLOCKS = 2048
FINAL_THREADS = 1024
#: Flat 4^3 class of each interior parity class zp * 4 + yp * 2 + xp.
INTERIOR_CLASSES = tuple(((1 + zp) * 4 + (1 + yp)) * 4 + (1 + xp)
                         for zp, yp, xp in itertools.product((0, 1),
                                                             repeat=3))


@functools.lru_cache(maxsize=None)
def _stencil_args(offsets):
    """(ctypes int array of the flat offsets, K, centre index or -1)."""
    import ctypes

    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"{len(offsets)} offsets; the kernels take 1.."
                         f"{MAX_OFFSETS}")
    if any(abs(c) > 2 for off in offsets for c in off):
        raise ValueError("the P2 kernels take offsets of radius <= 2")
    flat = [c for off in offsets for c in off]
    center = offsets.index((0, 0, 0)) if (0, 0, 0) in offsets else -1
    return (ctypes.c_int * len(flat))(*flat), len(offsets), center


@functools.lru_cache(maxsize=None)
def _deltas(offsets, lm: int, device) -> torch.Tensor:
    """Each offset's linear index step (dz lm + dy) lm + dx on the lm^3
    box, as an int32 tensor on `device` (made once per box size)."""
    return torch.tensor([(dz * lm + dy) * lm + dx for dz, dy, dx in offsets],
                        dtype=torch.int32, device=device)


def _check(v, tables, offsets, *others):
    """Check the kernels' inputs; return (lm, offsets as a tuple)."""
    offsets = tuple(map(tuple, offsets))
    lm = v.shape[0]
    check_lm(lm)
    shape = (lm,) * 3
    check_tensor(v, "v", shape)
    for name, t in others:
        check_tensor(t, name, shape, v.dtype)
    check_tensor(tables, "tables", (len(offsets), 64), v.dtype)
    return lm, offsets


def quad_blocks(lm: int) -> int:
    """Blocks of K21's first pass on an lm^3 box."""
    return min(-(-lm ** 3 // QUAD_THREADS), QUAD_MAX_BLOCKS)


def p2_residual(v: torch.Tensor, f: torch.Tensor, tables: torch.Tensor,
                offsets) -> torch.Tensor:
    """r = f - A v into a fresh tensor."""
    lm, offsets = _check(v, tables, offsets, ("f", f))
    offs, k, _ = _stencil_args(offsets)
    out = torch.empty_like(v)
    fn = getattr(build.library(), f"mg_p2_residual_{suffix(v.dtype)}")
    deltas = _deltas(offsets, lm, v.device)
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), f.data_ptr(), tables.data_ptr(),
                 deltas.data_ptr(), out.data_ptr(), lm, offs, k, stream(v))
    build.check(err, "p2_residual")
    LAUNCHES["p2_residual"] += 1
    return out


def p2_jacobi_sweep(v: torch.Tensor, f: torch.Tensor, tables: torch.Tensor,
                    offsets, w: float,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One snap weighted-Jacobi sweep from v into `out` (a fresh tensor if
    None); `out` must not be v or f."""
    lm, offsets = _check(v, tables, offsets, ("f", f))
    offs, k, center = _stencil_args(offsets)
    if center < 0:
        raise ValueError("p2_jacobi_sweep: the offsets have no centre")
    if out is None:
        out = torch.empty_like(v)
    check_tensor(out, "out", v.shape, v.dtype)
    if out.data_ptr() in (v.data_ptr(), f.data_ptr()):
        raise ValueError("p2_jacobi_sweep: out must not alias v or f")
    fn = getattr(build.library(), f"mg_p2_jacobi_{suffix(v.dtype)}")
    deltas = _deltas(offsets, lm, v.device)
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), f.data_ptr(), tables.data_ptr(),
                 deltas.data_ptr(), out.data_ptr(), lm, offs, k, center,
                 1.0 - w, w, stream(v))
    build.check(err, "p2_jacobi_sweep")
    LAUNCHES["p2_jacobi_sweep"] += 1
    return out


def p2_mass_quad(r: torch.Tensor, tables: torch.Tensor,
                 offsets) -> torch.Tensor:
    """q = r^T M r as a 0-dim f64 tensor on r's device."""
    lm, offsets = _check(r, tables, offsets)
    offs, k, _ = _stencil_args(offsets)
    nb = quad_blocks(lm)
    partials = torch.empty(nb, dtype=torch.float64, device=r.device)
    out = torch.empty(1, dtype=torch.float64, device=r.device)
    fn = getattr(build.library(), f"mg_p2_mass_quad_{suffix(r.dtype)}")
    deltas = _deltas(offsets, lm, r.device)
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), tables.data_ptr(), deltas.data_ptr(),
                 partials.data_ptr(), out.data_ptr(), lm, offs, k, nb,
                 stream(r))
    build.check(err, "p2_mass_quad")
    LAUNCHES["p2_mass_quad"] += 1
    return out[0]


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def _parity_views(lm: int, device):
    i = torch.arange(lm, device=device) % 2
    return i.view(-1, 1, 1), i.view(1, -1, 1), i.view(1, 1, -1)


def _interior_acc_ref(vt: torch.Tensor, tables: torch.Tensor, offsets,
                      skip: int = -1) -> torch.Tensor:
    """sum_k w_k[parity(p)] vt[p + off_k], k != skip, in offset order from
    a zero accumulator, zero weights skipped (the kernels' order); vt is
    zero off the interior, and beyond the box through the padding."""
    lm = vt.shape[0]
    pz, py, px = _parity_views(lm, vt.device)
    w8 = tables[:, list(INTERIOR_CLASSES)].reshape(-1, 2, 2, 2)
    up = F.pad(vt, (2,) * 6)
    acc = torch.zeros_like(vt)
    for k, (dz, dy, dx) in enumerate(offsets):
        if k == skip:
            continue
        w = w8[k][pz, py, px]
        x = up[2 + dz:2 + dz + lm, 2 + dy:2 + dy + lm, 2 + dx:2 + dx + lm]
        acc = torch.where(w != 0.0, acc + w * x, acc)
    return acc


def p2_residual_ref(v: torch.Tensor, f: torch.Tensor, tables: torch.Tensor,
                    offsets) -> torch.Tensor:
    """Plain version of p2_residual."""
    offsets = tuple(map(tuple, offsets))
    interior = box_interior_mask(v.shape, v.shape[0], v.device)
    acc = _interior_acc_ref(torch.where(interior, v, 0.0), tables, offsets)
    return f - torch.where(interior, acc, v)


def p2_jacobi_sweep_ref(v: torch.Tensor, f: torch.Tensor,
                        tables: torch.Tensor, offsets, w: float,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of p2_jacobi_sweep."""
    offsets = tuple(map(tuple, offsets))
    center = offsets.index((0, 0, 0))
    lm = v.shape[0]
    interior = box_interior_mask(v.shape, lm, v.device)
    acc = _interior_acc_ref(torch.where(interior, v, 0.0), tables, offsets,
                            skip=center)
    wc = tables[center, list(INTERIOR_CLASSES)]
    wd8 = torch.reciprocal(torch.where(wc == 0.0, 1.0, wc)) * w
    pz, py, px = _parity_views(lm, v.device)
    wd = wd8.reshape(2, 2, 2)[pz, py, px]
    upd = (1.0 - w) * v + wd * (f - acc)
    return torch.where(interior, upd, f, out=out)


def fixed_order_sum(vals: torch.Tensor, nblocks: int) -> torch.Tensor:
    """sum of the f64 values in K21's order: thread t of the nblocks x
    QUAD_THREADS grid adds vals[t], vals[t + stride], ... from 0, each
    block folds its threads as a tree (t += t + h, h = 128 ... 1), and one
    block of FINAL_THREADS does the same with the partials."""
    def strided(x, width):
        rows = -(-x.numel() // width)
        pad = x.new_zeros(rows * width - x.numel())
        m = torch.cat([x, pad]).view(rows, width)
        s = torch.zeros(width, dtype=x.dtype, device=x.device)
        for j in range(rows):
            s = s + m[j]
        return s

    def tree(x):
        while x.shape[-1] > 1:
            h = x.shape[-1] // 2
            x = x[..., :h] + x[..., h:]
        return x[..., 0]

    partials = tree(strided(vals, nblocks * QUAD_THREADS)
                    .view(nblocks, QUAD_THREADS))
    return tree(strided(partials, FINAL_THREADS))


def p2_mass_quad_ref(r: torch.Tensor, tables: torch.Tensor,
                     offsets) -> torch.Tensor:
    """Plain version of p2_mass_quad: r (M r) per node in the working type
    (true 4^3 classes, reads zero beyond the box, zero weights skipped),
    summed in f64 in the kernel's fixed order."""
    offsets = tuple(map(tuple, offsets))
    lm = r.shape[0]
    up = F.pad(r, (2,) * 6)
    acc = torch.zeros_like(r)
    for k, (dz, dy, dx) in enumerate(offsets):
        w = parity_gather(tables[k], r.shape, lm)
        x = up[2 + dz:2 + dz + lm, 2 + dy:2 + dy + lm, 2 + dx:2 + dx + lm]
        acc = torch.where(w != 0.0, acc + w * x, acc)
    return fixed_order_sum((r * acc).reshape(-1).double(), quad_blocks(lm))
