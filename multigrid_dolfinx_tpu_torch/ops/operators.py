"""Plane-free stencil operators on the logical (n+1)^3 box (torch).

The const subset of `multigrid_dolfinx_tpu.ops.operators`:

  * the constant-coefficient operator with Dirichlet identity rows, whose
    weights are Python floats and whose interior mask comes from index
    arithmetic — it stores nothing grid-sized;
  * the boundary-class-table operator, the zero-memory form of the
    consistent P1 mass matrix, and its `quadratic_form` / `mass_norm`,
    the plain FEM-L2 residual norm.

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


def _shifted(up: torch.Tensor, off: Offset, shape, r: int) -> torch.Tensor:
    return up[tuple(slice(r + o, r + o + s) for o, s in zip(off, shape))]


def _pad(u: torch.Tensor, r: int) -> torch.Tensor:
    return F.pad(u, (r, r) * u.ndim)


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """Plane-free compact-stencil operator on the logical node box.

    const mode (`const_weights` set): interior row p is
    sum_k w_k u[p + off_k] over interior neighbours; non-interior rows are
    the identity (the Dirichlet-eliminated stiffness).  class-table mode
    (`class_tables` set): the weight of offset k at node p is
    class_tables[k][class(p)], reads unmasked — the consistent mass matrix; `uniform_p1_mass` certifies that it is the P1
    mass of the uniform Kuhn grid with that diagonal."""

    offsets: Tuple[Offset, ...]
    logical_m: int
    grid_shape: Tuple[int, ...]
    const_weights: Optional[Tuple[float, ...]] = None
    class_tables: Optional[torch.Tensor] = None
    uniform_p1_mass: Optional[str] = None

    @property
    def ndim(self) -> int:
        return len(self.offsets[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.grid_shape)

    @property
    def radius(self) -> int:
        return max(max(abs(c) for c in off) for off in self.offsets)

    @property
    def is_const(self) -> bool:
        return self.const_weights is not None

    def center_index(self) -> int:
        return self.offsets.index((0,) * self.ndim)

    def dinv(self, dtype, device=None) -> torch.Tensor:
        """1 / diag of a const operator, from the interior mask."""
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

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        if self.class_tables is not None:
            return self._apply_class_tables(u)
        if self.is_const:
            return self._apply_const(u)
        raise NotImplementedError(
            "stored-planes operators (variable coefficient, Galerkin) are "
            "ROADMAP.md queue 1, item 14")


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
    """u^T A v as a device reduction."""
    return torch.sum(u * op.apply(v))


def mass_norm(M: StencilOperator, r: torch.Tensor) -> torch.Tensor:
    """FEM-L2 norm sqrt(r^T M r) (reference res_calculator semantics)."""
    return torch.sqrt(torch.clamp(quadratic_form(M, r, r), min=0.0))
