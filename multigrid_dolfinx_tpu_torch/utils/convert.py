"""Carry a hierarchy's state across from plain numpy arrays.

`hierarchy_from_numpy` rebuilds the port's Hierarchy from the state of a
JAX-package hierarchy (2D or 3D, lean or assembled) written out as numpy
arrays and Python scalars, so both packages can run from the same state.
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
lean one, whose const operator gives it).  The Chebyshev degree is the
config's and the window ratio 4.0 in both packages, so a JAX lean
Chebyshev hierarchy carried across this way with its lmax gives the same
Chebyshev window, hence the same solve.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SolverConfig
from ..fem.fast_const import mass_class_tables
from ..fem.norms import error_quadrature
from ..mesh import GridLevel
from ..ops.coarse import coarse_solver_from_numpy
from ..solver.hierarchy import (DTYPES, Hierarchy, check_problem, const_level,
                                mass_operator, resolve_device)


def hierarchy_from_numpy(arrays: dict, config: SolverConfig,
                         device="cuda") -> Hierarchy:
    """The port's Hierarchy on `device` (the CUDA card by default) from
    numpy state (see module doc)."""
    check_problem(config)
    device = resolve_device(device)
    dtype = DTYPES[config.dtype]
    ndim = config.problem.ndim

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    levels = []
    for lvl, st in zip(config.hierarchy.levels(), arrays["levels"]):
        grid = GridLevel(level=lvl, ndim=ndim, n=int(st["n"]))
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
    m_offsets, _ = mass_class_tables(config.problem)
    n_f = levels[-1].n
    M_fine = mass_operator(m_offsets, tensor(arrays["class_tables"]), n_f,
                           arrays.get("uniform_p1_mass",
                                      config.problem.diagonal))
    eq = error_quadrature(GridLevel(level=levels[-1].level, ndim=ndim, n=n_f),
                          config.problem)
    return Hierarchy(levels=tuple(levels), coarse=coarse, M_fine=M_fine,
                     err_quad=eq)
