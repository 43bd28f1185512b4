"""Stencil operators on the logical (n+1)^d box (torch).

The subset of `multigrid_dolfinx_tpu.ops.operators` the port runs:

  * the constant-coefficient operator with Dirichlet identity rows, whose
    weights are Python floats and whose interior mask comes from index
    arithmetic — it stores nothing grid-sized;
  * the stored-planes operator (variable coefficient, Galerkin coarse
    levels): K coefficient planes of the logical box, row p being
    sum_k planes[k][p] u[p + off_k] over in-box neighbours;
  * the boundary-class-table operator, the zero-memory form of the
    consistent P1 mass matrix, and its `quadratic_form` / `mass_norm`,
    the plain FEM-L2 residual norm;
  * the parity-table operator of constant-coefficient P2 on its half-step
    lattice: the weight of offset k at node p is parity_tables[k][class
    (p)] with per-axis classes {low face, even interior, odd interior,
    high face}, O(K 4^d) numbers for the whole operator (the stiffness
    Dirichlet-eliminated, the mass raw).

Storage is the logical box itself, contiguous and unpadded, so every
shifted read pads with zeros explicitly (the TPU kernels let rolls wrap
onto zero tile padding instead).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Offset = Tuple[int, ...]


def axis_range_mask(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """1D bool mask lo <= i <= hi over 0..n-1."""
    i = torch.arange(n, device=device)
    return (i >= lo) & (i <= hi)


def box_interior_mask(shape: Tuple[int, ...], logical_m: int,
                      device=None) -> torch.Tensor:
    """Interior = strictly inside the logical (logical_m)^d node box; built
    from per-axis index ranges, no stored mask."""
    m = None
    for axis, s in enumerate(shape):
        view = [1] * len(shape)
        view[axis] = s
        g = axis_range_mask(s, 1, logical_m - 2, device).view(view)
        m = g if m is None else m & g
    return m.expand(shape)


def axis_class(n: int, lm: int, device) -> torch.Tensor:
    """Per-axis boundary class: 0 at index 0, 2 at index lm-1, 1 inside."""
    i = torch.arange(n, device=device)
    return torch.where(i == 0, 0, torch.where(i == lm - 1, 2, 1))


def class_index(shape: Tuple[int, ...], lm: int, device) -> torch.Tensor:
    """Flat 3^d boundary-class index of every node."""
    cls = None
    for axis, s in enumerate(shape):
        view = [1] * len(shape)
        view[axis] = s
        c = axis_class(s, lm, device).view(view)
        cls = c if cls is None else cls * 3 + c
    return cls.expand(shape)


def parity_axis_class(n: int, lm: int, device) -> torch.Tensor:
    """Per-axis parity class: 0 at index 0, 3 at index lm-1, 1 at even
    and 2 at odd indices between."""
    i = torch.arange(n, device=device)
    return torch.where(i == 0, 0, torch.where(
        i == lm - 1, 3, torch.where(i % 2 == 0, 1, 2)))


def parity_gather(table: torch.Tensor, shape: Tuple[int, ...],
                  lm: int) -> torch.Tensor:
    """table[class(p)] at every node p of `shape`, for a flat (4^d,) class
    table, through per-axis class views (no grid-sized index array)."""
    d = len(shape)
    idx = []
    for axis, n in enumerate(shape):
        view = [1] * d
        view[axis] = n
        idx.append(parity_axis_class(n, lm, table.device).view(view))
    return table.view((4,) * d)[tuple(idx)]


def _shifted(up: torch.Tensor, off: Offset, shape, r: int) -> torch.Tensor:
    return up[tuple(slice(r + o, r + o + s) for o, s in zip(off, shape))]


def _pad(u: torch.Tensor, r: int) -> torch.Tensor:
    return F.pad(u, (r, r) * u.ndim)


def stencil_radius(offsets) -> int:
    return max(max(abs(c) for c in off) for off in offsets)


def apply_planes(u: torch.Tensor, planes: torch.Tensor, offsets,
                 skip: Optional[int] = None) -> torch.Tensor:
    """sum_k planes[k] * u[p + off_k] in the order of `offsets`, from a
    zero accumulator (the association of the planes kernels K15-K17),
    leaving out offset index `skip`.  Out-of-box neighbours read the zero
    padding; the kernels skip them, which is the same sum for finite
    planes."""
    r = stencil_radius(offsets)
    up = _pad(u, r)
    acc = torch.zeros_like(u)
    for k, off in enumerate(offsets):
        if k != skip:
            acc = acc + planes[k] * _shifted(up, off, u.shape, r)
    return acc


def planes_dinv(planes: torch.Tensor, center: int) -> torch.Tensor:
    """1 / diag from the centre plane, 1 where it is 0."""
    pc = planes[center]
    return 1.0 / torch.where(pc == 0.0, 1.0, pc)


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """Compact-stencil operator on the logical node box.

    const mode (`const_weights` set): interior row p is
    sum_k w_k u[p + off_k] over interior neighbours; non-interior rows are
    the identity (the Dirichlet-eliminated stiffness).  planes mode
    (`planes` set, (K, *grid_shape)): row p is sum_k planes[k][p]
    u[p + off_k], the planes always Dirichlet-eliminated (bc rows unit,
    bc columns zero).  class-table mode
    (`class_tables` set): the weight of offset k at node p is
    class_tables[k][class(p)], reads unmasked — the consistent mass
    matrix; `uniform_p1_mass` certifies that it is the P1 mass of the
    uniform Kuhn grid with that diagonal.  parity-table mode
    (`parity_tables` set, (K, 4^d)): the weight of offset k at node p is
    parity_tables[k][parity class(p)] (parity_gather); boundary_mode
    'identity' is the Dirichlet-eliminated stiffness (reads
    interior-masked, non-interior rows the identity), 'raw' the
    un-eliminated operator (reads and rows as they are inside the box,
    the consistent P2 mass)."""

    offsets: Tuple[Offset, ...]
    logical_m: int
    grid_shape: Tuple[int, ...]
    const_weights: Optional[Tuple[float, ...]] = None
    class_tables: Optional[torch.Tensor] = None
    uniform_p1_mass: Optional[str] = None
    planes: Optional[torch.Tensor] = None
    parity_tables: Optional[torch.Tensor] = None
    boundary_mode: str = "identity"

    @property
    def ndim(self) -> int:
        return len(self.offsets[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.grid_shape)

    @property
    def radius(self) -> int:
        return stencil_radius(self.offsets)

    @property
    def axis_only(self) -> bool:
        """Does every offset touch at most one axis (2-colourable by
        coordinate-sum parity)?"""
        return all(sum(1 for c in off if c != 0) <= 1 for off in self.offsets)

    @property
    def is_const(self) -> bool:
        return self.const_weights is not None

    def center_index(self) -> int:
        return self.offsets.index((0,) * self.ndim)

    def diag(self) -> torch.Tensor:
        """The centre plane of a planes operator; the gathered centre
        weight of a parity operator (1 on identity rows)."""
        if self.parity_tables is not None:
            d = parity_gather(self.parity_tables[self.center_index()],
                              self.shape, self.logical_m)
            if self.boundary_mode == "identity":
                interior = box_interior_mask(self.shape, self.logical_m,
                                             d.device)
                return torch.where(interior, d, 1.0)
            return d
        return self.planes[self.center_index()]

    def dinv(self, dtype, device=None) -> torch.Tensor:
        """1 / diag: from the centre plane of a planes operator or the
        diagonal of a parity one (1 where it is 0), else from the const
        weight and the interior mask."""
        if self.parity_tables is not None:
            d = self.diag()
            return 1.0 / torch.where(d == 0.0, 1.0, d)
        if self.planes is not None:
            return planes_dinv(self.planes, self.center_index())
        w = self.const_weights[self.center_index()]
        interior = box_interior_mask(self.shape, self.logical_m, device)
        one = torch.ones((), dtype=dtype, device=device)
        return torch.where(interior, one / w, one)

    def _apply_const(self, u: torch.Tensor) -> torch.Tensor:
        interior = box_interior_mask(u.shape, self.logical_m, u.device)
        ut = torch.where(interior, u, 0.0)
        r = self.radius
        up = _pad(ut, r)
        zero = (0,) * self.ndim
        out = None
        for k, off in enumerate(self.offsets):
            w = self.const_weights[k]
            if w == 0.0:
                continue
            term = w * (ut if off == zero else _shifted(up, off, u.shape, r))
            out = term if out is None else out + term
        return torch.where(interior, out, u)

    def _apply_class_tables(self, u: torch.Tensor) -> torch.Tensor:
        cls = class_index(u.shape, self.logical_m, u.device)
        r = self.radius
        up = _pad(u, r)
        out = None
        for k, off in enumerate(self.offsets):
            w = self.class_tables[k].reshape(-1)[cls]
            term = w * _shifted(up, off, u.shape, r)
            out = term if out is None else out + term
        return out

    def _apply_parity(self, u: torch.Tensor) -> torch.Tensor:
        lm = self.logical_m
        identity = self.boundary_mode == "identity"
        interior = box_interior_mask(u.shape, lm, u.device)
        src = torch.where(interior, u, 0.0) if identity else u
        r = self.radius
        up = _pad(src, r)
        out = None
        for k, off in enumerate(self.offsets):
            w = parity_gather(self.parity_tables[k], u.shape, lm)
            term = w * _shifted(up, off, u.shape, r)
            out = term if out is None else out + term
        return torch.where(interior, out, u) if identity else out

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        if self.parity_tables is not None:
            return self._apply_parity(u)
        if self.class_tables is not None:
            return self._apply_class_tables(u)
        if self.is_const:
            return self._apply_const(u)
        return apply_planes(u, self.planes, self.offsets)


def detect_const_stencil(offsets, planes: np.ndarray,
                         interior: np.ndarray) -> Optional[Tuple[float, ...]]:
    """Setup-time check (numpy): constant interior weights with symmetric
    column elimination and identity boundary rows?  Returns the per-offset
    weights, or None."""
    ndim = interior.ndim
    zero = (0,) * ndim
    shape = interior.shape
    if not interior.any():
        return None
    weights = []
    rmax = max(max(abs(c) for c in off) for off in offsets)
    ipad = np.pad(interior, rmax, constant_values=False)
    for k, off in enumerate(offsets):
        sl = tuple(slice(rmax + o, rmax + o + s) for o, s in zip(off, shape))
        nbr_int = ipad[sl]
        sample = interior & nbr_int
        w = float(planes[k][sample].flat[0]) if sample.any() else 0.0
        expect = np.where(interior, w * nbr_int, 0.0)
        if off == zero:
            expect = np.where(interior, expect, 1.0)
        if not np.allclose(planes[k], expect, rtol=0.0, atol=1e-14):
            return None
        weights.append(w)
    return tuple(weights)


def quadratic_form(op: StencilOperator, u: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """u^T A v as a device reduction, summed in f64 and rounded to u's
    dtype: the sum's order differs between the CPU and the card, and in
    f64 that difference stays below an f32 ulp of the result."""
    return torch.sum(u * op.apply(v), dtype=torch.float64).to(u.dtype)


def mass_norm(M: StencilOperator, r: torch.Tensor) -> torch.Tensor:
    """FEM-L2 norm sqrt(r^T M r) (reference res_calculator semantics)."""
    return torch.sqrt(torch.clamp(quadratic_form(M, r, r), min=0.0))
