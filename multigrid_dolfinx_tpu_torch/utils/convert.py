"""Carry a hierarchy's state across from plain numpy arrays.

`hierarchy_from_numpy` rebuilds the port's Hierarchy from the state of a
JAX-package hierarchy (2D or 3D, lean or assembled, the 2D or 3D
variable-kappa build or the 3D P2 build) written out as numpy arrays and
Python scalars, so both packages can run from the same state.
It imports nothing of JAX; the caller does the jax -> numpy step, e.g.

    arrays = {
        "levels": [{"b": np.asarray(lv.b), "g": np.asarray(lv.g),
                    "n": lv.n, "offsets": lv.A.offsets,
                    "weights": lv.A.const_weights,
                    "lmax": float(lv.sm.lmax),
                    "dinv": None or np.asarray(lv.sm.dinv)}
                   for lv in hier.levels],
        "coarse": {"factor": np.asarray(hier.coarse.factor),
                   "piv": None or np.asarray(hier.coarse.piv),
                   "kind": hier.coarse.kind},
        "class_tables": np.asarray(hier.M_fine.class_tables),
        "uniform_p1_mass": hier.M_fine.uniform_p1_mass,
    }

with `dinv` the stored 1/diag A of an assembled hierarchy (None for a
lean one, whose const operator gives it).  `"uniform_p1_mass"` is carried
across as it is given: a diagonal ('right' / 'left') certifies the class
tables as the uniform P1 mass and the 3D check runs on kernel K4, while
None (the JAX StencilOperator's default, a mass built without the
certificate) leaves them uncertified and the check runs on kernel K38
over the tables (solver/fmg.check_norm).  Without the key the config's
diagonal certifies them.  A level of a P2 hierarchy
(the config has degree 2) carries `"parity_tables":
np.asarray(lv.A.parity_tables)` and its `offsets` (and may carry its
lattice size `"lm"`), and the mass comes as `"m_parity_tables"` and
`"m_offsets"` instead of `class_tables`.  A level of a variable-kappa
hierarchy carries `"planes": np.asarray(lv.A.planes)` and its `offsets`
instead of `weights` (the config then has kappa set); a `dinv` it
carries is not read, the centre plane gives it.  The Chebyshev degree is the
config's and the window ratio 4.0 in both packages, so a JAX lean
Chebyshev hierarchy carried across this way with its lmax gives the same
Chebyshev window, hence the same solve.

`halo_slab_from_numpy` cuts a level's global numpy array (the logical
box, or one padded in z as the JAX package's build_lean_hierarchy(...,
pad_points=plan) leaves it) into a rank's z-slab under the distributed
plan (parallel.halo3d.ZPlan), as the port's distributed build lays it
out: rows past the level's last plane are zero.  `halo_rows_from_numpy`
does the same for a 2D level and a rank's row strip (parallel.halo).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SolverConfig
from ..fem.fast_const import mass_class_tables
from ..fem.norms import error_quadrature
from ..mesh import GridLevel
from ..ops.coarse import coarse_solver_from_numpy
from ..solver.hierarchy import (DTYPES, Hierarchy, check_p2_cycle,
                                check_problem, check_var_cycle, const_level,
                                mass_operator, p2_level, p2_mass_operator,
                                planes_level, resolve_device)


def hierarchy_from_numpy(arrays: dict, config: SolverConfig,
                         device="cuda") -> Hierarchy:
    """The port's Hierarchy on `device` (the CUDA card by default) from
    numpy state (see module doc)."""
    var = config.problem.kappa is not None
    p2 = config.problem.degree == 2
    check_problem(config, var=var, p2=p2)
    if var:
        check_var_cycle(config)
    if p2:
        check_p2_cycle(config)
    device = resolve_device(device)
    dtype = DTYPES[config.dtype]
    ndim = config.problem.ndim

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    levels = []
    for lvl, st in zip(config.hierarchy.levels(), arrays["levels"]):
        if p2:
            grid = GridLevel(level=lvl, ndim=ndim, n=int(st["n"]) // 2)
            if int(st.get("lm", st["n"] + 1)) != int(st["n"]) + 1:
                raise ValueError("a P2 level's lm must be n + 1")
            levels.append(p2_level(st["offsets"], grid, tensor(st["b"]),
                                   tensor(st["g"]), config,
                                   tensor(st["parity_tables"])))
            continue
        grid = GridLevel(level=lvl, ndim=ndim, n=int(st["n"]))
        if st.get("planes") is not None:
            levels.append(planes_level(
                st["offsets"], tensor(st["planes"]), grid, tensor(st["b"]),
                tensor(st["g"]), config))
            continue
        dinv = st.get("dinv")
        levels.append(const_level(
            st["offsets"], st["weights"], grid, tensor(st["b"]),
            tensor(st["g"]), config, lmax=float(st["lmax"]),
            dinv=None if dinv is None else tensor(dinv)))
    if len(levels) != config.hierarchy.num_levels:
        raise ValueError("arrays['levels'] does not match the config's levels")

    c = arrays["coarse"]
    n0 = levels[0].n
    coarse = coarse_solver_from_numpy(c["factor"], c.get("piv"), c["kind"],
                                      (n0 + 1,) * ndim, device)
    n_f = levels[-1].n
    grid_f = GridLevel(level=levels[-1].level, ndim=ndim,
                       n=n_f // 2 if p2 else n_f)
    if p2:
        M_fine = p2_mass_operator(arrays["m_offsets"], grid_f,
                                  tensor(arrays["m_parity_tables"]))
    else:
        m_offsets, _ = mass_class_tables(dataclasses.replace(
            config.problem, kappa=None, reaction=0.0))
        M_fine = mass_operator(m_offsets, tensor(arrays["class_tables"]),
                               n_f, arrays.get("uniform_p1_mass",
                                               config.problem.diagonal))
    eq = error_quadrature(grid_f, config.problem)
    return Hierarchy(levels=tuple(levels), coarse=coarse, M_fine=M_fine,
                     err_quad=eq)


def _leading_cut(a: np.ndarray, plan, li: int, rank: int,
                 ndim: int) -> np.ndarray:
    lm = plan.lms[li]
    a = np.asarray(a)
    if a.ndim != ndim:
        raise ValueError(f"expected a {ndim}D level array, got {a.shape}")
    a = a[(slice(0, lm),) * ndim]
    if li < plan.shard_from:
        return a.copy()
    mz = plan.mz(li)
    out = np.zeros((mz,) + (lm,) * (ndim - 1), dtype=a.dtype)
    lo = rank * mz
    hi = min(lo + mz, lm)
    if hi > lo:
        out[:hi - lo] = a[lo:hi]
    return out


def halo_slab_from_numpy(a: np.ndarray, plan, li: int, rank: int) -> np.ndarray:
    """Rank `rank`'s (mz, lm, lm) z-slab of level li's global array `a`
    under `plan` (a parallel.halo3d.ZPlan); a replicated level (li <
    plan.shard_from) gives the whole (lm, lm, lm) box.  y and x are
    cropped to lm, rows past lm - 1 are zero."""
    return _leading_cut(a, plan, li, rank, 3)


def halo_rows_from_numpy(a: np.ndarray, plan, li: int, rank: int) -> np.ndarray:
    """Rank `rank`'s (m, lm) row strip of 2D level li's global array `a`
    (the logical box, or one padded as the JAX package's
    build_lean_hierarchy(..., pad_points=plan) leaves it) under `plan`
    (the parallel.halo3d.ZPlan of a 2D configuration); a replicated level
    gives the whole (lm, lm) box.  Columns are cropped to lm, rows past
    lm - 1 are zero."""
    return _leading_cut(a, plan, li, rank, 2)
