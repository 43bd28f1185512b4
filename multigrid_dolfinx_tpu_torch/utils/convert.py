"""Carry a hierarchy's state across from plain numpy arrays.

`hierarchy_from_numpy` rebuilds the port's Hierarchy from the state of a
JAX-package hierarchy written out as numpy arrays and Python scalars, so
both packages can run from the same state.  It imports nothing of JAX;
the caller does the jax -> numpy step, e.g.

    arrays = {
        "levels": [{"b": np.asarray(lv.b), "g": np.asarray(lv.g),
                    "n": lv.n, "wc": wc, "woff": woff,
                    "lmax": float(lv.sm.lmax)} for lv in hier.levels],
        "coarse": {"factor": np.asarray(hier.coarse.factor),
                   "piv": None or np.asarray(hier.coarse.piv),
                   "kind": hier.coarse.kind},
        "class_tables": np.asarray(hier.M_fine.class_tables),
        "uniform_p1_mass": hier.M_fine.uniform_p1_mass,
    }

with (wc, woff) the const-7 weights of each level's operator.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SolverConfig
from ..fem.fast_const import mass_class_tables
from ..fem.norms import error_quadrature
from ..mesh import GridLevel
from ..ops.coarse import coarse_solver_from_numpy
from ..ops.dispatch import POISSON7_3D_OFFSETS
from ..ops.operators import StencilOperator
from ..ops.smoothers import SmootherData
from ..solver.hierarchy import (DTYPES, Hierarchy, Level, check_problem,
                                mass_operator, resolve_device)


def hierarchy_from_numpy(arrays: dict, config: SolverConfig,
                         device) -> Hierarchy:
    """The port's Hierarchy on `device` from numpy state (see module doc)."""
    check_problem(config)
    device = resolve_device(device)
    dtype = DTYPES[config.dtype]

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    levels = []
    for lvl, st in zip(config.hierarchy.levels(), arrays["levels"]):
        n = int(st["n"])
        wc, woff = float(st["wc"]), float(st["woff"])
        weights = tuple(wc if off == (0, 0, 0) else woff
                        for off in POISSON7_3D_OFFSETS)
        A = StencilOperator(
            offsets=POISSON7_3D_OFFSETS, logical_m=n + 1,
            grid_shape=(n + 1,) * 3, const_weights=weights)
        sm = SmootherData(lmax=float(st["lmax"]), omega=config.cycle.omega)
        levels.append(Level(A=A, sm=sm, b=tensor(st["b"]),
                            g=tensor(st["g"]), n=n, level=lvl))
    if len(levels) != config.hierarchy.num_levels:
        raise ValueError("arrays['levels'] does not match the config's levels")

    c = arrays["coarse"]
    n0 = levels[0].n
    coarse = coarse_solver_from_numpy(c["factor"], c.get("piv"), c["kind"],
                                      (n0 + 1,) * 3, device)
    m_offsets, _ = mass_class_tables(config.problem)
    n_f = levels[-1].n
    M_fine = mass_operator(m_offsets, tensor(arrays["class_tables"]), n_f,
                           arrays.get("uniform_p1_mass",
                                      config.problem.diagonal))
    eq = error_quadrature(GridLevel(level=levels[-1].level, ndim=3, n=n_f),
                          config.problem)
    return Hierarchy(levels=tuple(levels), coarse=coarse, M_fine=M_fine,
                     err_quad=eq)
