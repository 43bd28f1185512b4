"""Plain PyTorch reference for -div(kappa grad u) = f with P1 elements on
the Kuhn-tetrahedra cube, Dirichlet data g = u* on the whole boundary.

Written from the finite-element definition and independent of the
program: the stiffness is applied cell by cell (six tetrahedra a cell,
kappa at each tetrahedron's centroid, which integrates an affine kappa
exactly), the load of a constant f at an interior node is f h^3 (the
node's hat function integrates to h^3 on this mesh), and the residual
norm is the consistent-mass form sum_T |T|/20 (sum_a r_a^2 + (sum_a
r_a)^2).  Arrays are (n+1)^3 node grids indexed [ix, iy, iz]; node p sits
at p h.  Everything is computed in slabs of the first axis so that a
512^3 grid fits beside what the card already holds.

`solve_mg` is a plain geometric multigrid solver of the same system (Jacobi
V-cycles on rediscretised levels).  Only the control runs it: computed in
a lower precision, it takes the program's place.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Problem:
    """n elements a side; u* = 1 + a x^2 + b y^2 + c z^2 (coef = (a, b,
    c)), f = -2 (a + b + c); kappa = k0 + kx x + ky y + kz z, or 1 where
    None; the Kuhn split along (0,0,0)-(1,1,1) ('right') or its mirror in
    the first axis ('left')."""

    n: int
    coef: Tuple[float, float, float]
    kappa: Optional[Tuple[float, float, float, float]] = None
    diagonal: str = "right"

    @property
    def h(self) -> float:
        return 1.0 / self.n

    @property
    def f(self) -> float:
        return -2.0 * sum(self.coef)

    def exact(self, x, y, z):
        a, b, c = self.coef
        return 1.0 + a * x * x + b * y * y + c * z * z


def kuhn_tets(diagonal: str):
    """Vertex offsets of the six tetrahedra of a unit cell: the monotone
    lattice paths from (0,0,0) to (1,1,1), mirrored in the first axis for
    'left'."""
    tets = []
    for order in itertools.permutations(range(3)):
        v = [0, 0, 0]
        verts = [tuple(v)]
        for axis in order:
            v[axis] = 1
            verts.append(tuple(v))
        tets.append(verts)
    if diagonal == "left":
        tets = [[(1 - x, y, z) for (x, y, z) in t] for t in tets]
    elif diagonal != "right":
        raise ValueError(f"bad diagonal {diagonal!r}")
    return tets


def unit_stiffness(verts) -> np.ndarray:
    """4x4 P1 stiffness of a tetrahedron with these vertices at h = 1:
    vol * grad(lambda_a) . grad(lambda_b)."""
    p = np.asarray(verts, dtype=np.float64)
    edges = p[1:] - p[0]
    vol = abs(np.linalg.det(edges)) / 6.0
    g123 = np.linalg.inv(edges).T          # rows: grad lambda_1..3
    grads = np.vstack([-g123.sum(axis=0), g123])
    return vol * grads @ grads.T


def _tets(diagonal: str):
    return [(t, unit_stiffness(t), tuple(float(np.mean([v[a] for v in t]))
                                         for a in range(3)))
            for t in kuhn_tets(diagonal)]


def _axis(vals: torch.Tensor, axis: int) -> torch.Tensor:
    shape = [1, 1, 1]
    shape[axis] = vals.numel()
    return vals.view(shape)


def node_coords(p: Problem, lo: int, hi: int, dtype, device):
    """x, y, z of nodes [lo, hi) along the first axis, broadcastable."""
    h = p.h
    m = p.n + 1
    x = _axis(torch.arange(lo, hi, device=device, dtype=torch.float64)
              * h, 0)
    y = _axis(torch.arange(m, device=device, dtype=torch.float64) * h, 1)
    z = _axis(torch.arange(m, device=device, dtype=torch.float64) * h, 2)
    return x.to(dtype), y.to(dtype), z.to(dtype)


def boundary_mask(p: Problem, lo: int, hi: int, device) -> torch.Tensor:
    m = p.n + 1
    ix = _axis(torch.arange(lo, hi, device=device), 0)
    iy = _axis(torch.arange(m, device=device), 1)
    iz = _axis(torch.arange(m, device=device), 2)
    return ((ix == 0) | (ix == p.n) | (iy == 0) | (iy == p.n)
            | (iz == 0) | (iz == p.n))


def dirichlet(p: Problem, lo: int, hi: int, dtype, device) -> torch.Tensor:
    """g on nodes [lo, hi): u* on the boundary, 0 inside."""
    x, y, z = node_coords(p, lo, hi, torch.float64, device)
    u = p.exact(x, y, z).expand(hi - lo, p.n + 1, p.n + 1)
    return torch.where(boundary_mask(p, lo, hi, device), u, 0.0).to(dtype)


def stiffness_rows(p: Problem, u: torch.Tensor, lo: int) -> torch.Tensor:
    """A_raw u over the cells between the nodes u covers (nodes [lo, lo +
    m) of the first axis, all of the other two).  A row is whole where all
    its cells lie in that range or outside the cube."""
    m = u.shape[0]
    nc, n = m - 1, p.n
    out = torch.zeros_like(u)
    h = p.h
    for verts, K, cen in _tets(p.diagonal):
        if p.kappa is None:
            kap = h
        else:
            k0, kx, ky, kz = p.kappa
            ci = lambda a, cnt, start: _axis(
                (torch.arange(start, start + cnt, device=u.device,
                              dtype=torch.float64) + cen[a]) * h, a)
            kap = ((k0 + kx * ci(0, nc, lo) + ky * ci(1, n, 0)
                    + kz * ci(2, n, 0)) * h).to(u.dtype)
        uv = [u[vx:vx + nc, vy:vy + n, vz:vz + n] for vx, vy, vz in verts]
        for a, (vx, vy, vz) in enumerate(verts):
            acc = (float(K[a, 0]) * uv[0] + float(K[a, 1]) * uv[1]
                   + float(K[a, 2]) * uv[2] + float(K[a, 3]) * uv[3])
            out[vx:vx + nc, vy:vy + n, vz:vz + n] += kap * acc
    return out


def stiffness_diag(p: Problem, dtype, device) -> torch.Tensor:
    """diag A_raw over the whole grid."""
    n, h = p.n, p.h
    out = torch.zeros((n + 1,) * 3, dtype=dtype, device=device)
    for verts, K, cen in _tets(p.diagonal):
        if p.kappa is None:
            kap = torch.full((n,) * 3, h, dtype=dtype, device=device)
        else:
            k0, kx, ky, kz = p.kappa
            c = [_axis((torch.arange(n, device=device, dtype=torch.float64)
                        + cen[a]) * h, a) for a in range(3)]
            kap = ((k0 + kx * c[0] + ky * c[1] + kz * c[2]) * h).to(
                dtype).expand((n,) * 3)
        for a, (vx, vy, vz) in enumerate(verts):
            out[vx:vx + n, vy:vy + n, vz:vz + n] += float(K[a, a]) * kap
    return out


def rows_slab(p: Problem, u: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """A_raw u on rows [lo, hi) in f64, from u's nodes [lo - 1, hi + 1)."""
    elo, ehi = max(lo - 1, 0), min(hi + 1, p.n + 1)
    return stiffness_rows(p, u[elo:ehi].to(torch.float64),
                          elo)[lo - elo:hi - elo]


def residual_slab(p: Problem, u: torch.Tensor, lo: int,
                  hi: int) -> torch.Tensor:
    """r = b - A u on nodes [lo, hi), in f64: g - u on the boundary;
    f h^3 - A_raw u~ inside, u~ = u inside and g on the boundary."""
    elo, ehi = max(lo - 1, 0), min(hi + 1, p.n + 1)
    dev = u.device
    ue = u[elo:ehi].to(torch.float64)
    bnd = boundary_mask(p, elo, ehi, dev)
    g = dirichlet(p, elo, ehi, torch.float64, dev)
    rows = stiffness_rows(p, torch.where(bnd, g, ue), elo)
    s = slice(lo - elo, hi - elo)
    return torch.where(bnd[s], (g - ue)[s], p.f * p.h ** 3 - rows[s])


def rhs_slab(p: Problem, lo: int, hi: int, device) -> torch.Tensor:
    """The eliminated right-hand side on nodes [lo, hi) in f64: g on the
    boundary, f h^3 - A_raw g inside (the residual of the zero iterate)."""
    elo, ehi = max(lo - 1, 0), min(hi + 1, p.n + 1)
    g = dirichlet(p, elo, ehi, torch.float64, device)
    rows = stiffness_rows(p, g, elo)
    s = slice(lo - elo, hi - elo)
    return torch.where(boundary_mask(p, lo, hi, device), g[s],
                       p.f * p.h ** 3 - rows[s])


def mass_sq_cells(p: Problem, r: torch.Tensor) -> torch.Tensor:
    """sum over the cells between r's nodes of r^T M_T r, in f64."""
    m = r.shape[0]
    nc, n = m - 1, p.n
    vol = p.h ** 3 / 6.0
    acc = torch.zeros((), dtype=torch.float64, device=r.device)
    for verts, _, _ in _tets(p.diagonal):
        rv = [r[vx:vx + nc, vy:vy + n, vz:vz + n] for vx, vy, vz in verts]
        s = rv[0] + rv[1] + rv[2] + rv[3]
        sq = rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2] + rv[3] * rv[3]
        acc = acc + torch.sum(sq + s * s)
    return acc * (vol / 20.0)


def residual_norms(p: Problem, u: torch.Tensor, block: int = 32):
    """(||b - A u||_M, ||b - A 0||_M, max |b - A u|, max |b - A 0|) in
    f64, slab by slab over cells."""
    rs = r0 = m = m0 = 0.0
    for c0 in range(0, p.n, block):
        c1 = min(c0 + block, p.n)
        r = residual_slab(p, u, c0, c1 + 1)
        b = rhs_slab(p, c0, c1 + 1, u.device)
        rs += float(mass_sq_cells(p, r))
        r0 += float(mass_sq_cells(p, b))
        m = max(m, float(r.abs().max()))
        m0 = max(m0, float(b.abs().max()))
    return rs ** 0.5, r0 ** 0.5, m, m0


def probe_vector(p: Problem, seed: int, device) -> torch.Tensor:
    """A seeded random z in [-1, 1), 0 on the boundary, in f32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    z = torch.rand((p.n + 1,) * 3, generator=gen, dtype=torch.float32,
                   device=device) * 2.0 - 1.0
    return torch.where(boundary_mask(p, 0, p.n + 1, device), 0.0, z)


def problem_errors(p: Problem, b: torch.Tensor, g: torch.Tensor,
                   apply_op: Callable, z: torch.Tensor,
                   block: int = 32) -> dict:
    """Largest relative gaps of a program's finest b, g and operator from
    the reference's: b inside against max |b| inside, b and g on the
    boundary against max |g|, and A z (interior rows) against max |A z|
    for a probe z that is 0 on the boundary.  apply_op(z, lo, hi) gives
    the program's operator on rows [lo, hi)."""
    dev = b.device
    d = dict(bi=0.0, bb=0.0, g=0.0, op=0.0)
    m = dict(bi=0.0, g=0.0, op=0.0)
    for lo in range(0, p.n + 1, block):
        hi = min(lo + block, p.n + 1)
        bnd = boundary_mask(p, lo, hi, dev)
        bref = rhs_slab(p, lo, hi, dev)
        gref = dirichlet(p, lo, hi, torch.float64, dev)
        db = (b[lo:hi].to(torch.float64) - bref).abs()
        d["bi"] = max(d["bi"], float(torch.where(bnd, 0.0, db).max()))
        d["bb"] = max(d["bb"], float(torch.where(bnd, db, 0.0).max()))
        d["g"] = max(d["g"], float((g[lo:hi].to(torch.float64)
                                    - gref).abs().max()))
        m["bi"] = max(m["bi"], float(torch.where(bnd, 0.0,
                                                 bref.abs()).max()))
        m["g"] = max(m["g"], float(gref.abs().max()))
        ref = rows_slab(p, z, lo, hi)
        prog = apply_op(z, lo, hi).to(torch.float64)
        d["op"] = max(d["op"], float(torch.where(bnd, 0.0,
                                                 (prog - ref).abs()).max()))
        m["op"] = max(m["op"], float(torch.where(bnd, 0.0,
                                                 ref.abs()).max()))
    return {"b_interior": d["bi"] / m["bi"], "b_boundary": d["bb"] / m["g"],
            "g": d["g"] / m["g"], "operator": d["op"] / m["op"]}


# ----------------------------------------------------------------------
# a plain geometric multigrid solver (the control runs it in a lower
# precision in the program's place)
# ----------------------------------------------------------------------

def _prolong_1d(c: torch.Tensor, axis: int) -> torch.Tensor:
    m = c.shape[axis]
    shape = list(c.shape)
    shape[axis] = 2 * m - 1
    f = torch.zeros(shape, dtype=c.dtype, device=c.device)
    even = [slice(None)] * 3
    even[axis] = slice(0, None, 2)
    f[tuple(even)] = c
    odd = [slice(None)] * 3
    odd[axis] = slice(1, None, 2)
    lo = [slice(None)] * 3
    lo[axis] = slice(0, m - 1)
    hi = [slice(None)] * 3
    hi[axis] = slice(1, m)
    f[tuple(odd)] = 0.5 * (c[tuple(lo)] + c[tuple(hi)])
    return f


def _restrict_1d(f: torch.Tensor, axis: int) -> torch.Tensor:
    m = (f.shape[axis] + 1) // 2
    sl = [slice(None)] * 3
    sl[axis] = slice(0, None, 2)
    c = f[tuple(sl)].clone()
    odd = [slice(None)] * 3
    odd[axis] = slice(1, None, 2)
    half = 0.5 * f[tuple(odd)]
    lo = [slice(None)] * 3
    lo[axis] = slice(0, m - 1)
    hi = [slice(None)] * 3
    hi[axis] = slice(1, m)
    c[tuple(lo)] += half
    c[tuple(hi)] += half
    return c


def prolong(c: torch.Tensor) -> torch.Tensor:
    for axis in range(3):
        c = _prolong_1d(c, axis)
    return c


def restrict(f: torch.Tensor) -> torch.Tensor:
    for axis in range(3):
        f = _restrict_1d(f, axis)
    return f


def solve_mg(p: Problem, dtype, device, rtol: float, max_cycles: int = 40,
             nu: int = 3, omega: float = 2.0 / 3.0):
    """V(nu, nu) weighted-Jacobi cycles on the rediscretised levels n, n/2,
    ... down to an odd n or n <= 4 (a dense solve there, in f64, since
    torch has no dense solve in 16-bit types), every array in `dtype`,
    from u = g, until the plain residual of the interior rows falls to
    rtol of the zero iterate's or stops falling.  Returns (u, cycles)."""
    levels = [p]
    while levels[-1].n % 2 == 0 and levels[-1].n > 4:
        levels.append(dataclasses.replace(levels[-1], n=levels[-1].n // 2))
    diags = [stiffness_diag(q, dtype, device) for q in levels]
    inside = [~boundary_mask(q, 0, q.n + 1, device) for q in levels]

    def apply(li, v):
        q = levels[li]
        vt = torch.where(inside[li], v, 0.0)
        return torch.where(inside[li], stiffness_rows(q, vt, 0), v)

    qc = levels[-1]
    m = qc.n + 1
    idx = torch.nonzero(inside[-1].reshape(-1)).reshape(-1)
    cols = []
    for j in idx.tolist():
        e = torch.zeros(m ** 3, dtype=torch.float64, device=device)
        e[j] = 1.0
        cols.append(apply(len(levels) - 1, e.view(m, m, m)).reshape(-1)[idx])
    coarse = torch.stack(cols, dim=1)

    def coarse_solve(f):
        x = torch.zeros(m ** 3, dtype=torch.float64, device=device)
        x[idx] = torch.linalg.solve(coarse, f.reshape(-1)[idx].double())
        return x.view(m, m, m).to(dtype)

    def cycle(li, v, f):
        if li == len(levels) - 1:
            return coarse_solve(f)
        for _ in range(nu):
            v = v + torch.where(inside[li],
                                omega * (f - apply(li, v)) / diags[li], 0.0)
        r = torch.where(inside[li], f - apply(li, v), 0.0)
        fc = torch.where(inside[li + 1], restrict(r), 0.0)
        vc = cycle(li + 1, torch.zeros_like(fc), fc)
        v = v + torch.where(inside[li], prolong(vc), 0.0)
        for _ in range(nu):
            v = v + torch.where(inside[li],
                                omega * (f - apply(li, v)) / diags[li], 0.0)
        return v

    # the correction form: u = g + e, e = 0 on the boundary, A e = f h^3 -
    # A_raw g on the interior rows
    g = dirichlet(p, 0, p.n + 1, dtype, device)
    f = torch.where(inside[0], p.f * p.h ** 3 - stiffness_rows(p, g, 0), 0.0)
    e = torch.zeros_like(g)
    norm0 = float(torch.linalg.vector_norm(f.double()))
    best, stall, k = float("inf"), 0, 0
    while k < max_cycles:
        r = torch.where(inside[0], f - apply(0, e), 0.0)
        rn = float(torch.linalg.vector_norm(r.double()))
        if rn <= rtol * norm0:
            break
        stall = stall + 1 if rn > 0.9 * best else 0
        best = min(best, rn)
        if stall >= 3:
            break
        e = e + cycle(0, torch.zeros_like(e), r)
        k += 1
    return torch.where(inside[0], g + e, g), k
