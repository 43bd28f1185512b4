"""The systems a cell can drive: the port (the system under test) and the
plain reference put in its place (the control).  Both take a problem's
data and return the converged u; both expose the finest level's b, g and
operator so that the check can judge them.

A configuration file says what to build (see portbench/configs/); a
traffic file says which entry point a request calls.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import spec


class Answer(NamedTuple):
    u: torch.Tensor
    cycles: int
    converged: bool


class Finest(NamedTuple):
    """The finest level as the system built it: b, g, and its operator
    applied to a probe z on rows [lo, hi)."""

    b: torch.Tensor
    g: torch.Tensor
    apply_op: Callable


def coefficients(seed: int, index: int, lo: float, hi: float):
    """(a, b, c) of u* = 1 + a x^2 + b y^2 + c z^2 for request `index` of
    run `seed`: uniform in [lo, hi), the same for the same pair."""
    rng = np.random.default_rng([int(seed) % (2 ** 64), int(index)])
    return tuple(float(v) for v in rng.uniform(lo, hi, size=3))


def reference_problem(config: dict, coef):
    prob = config["problem"]
    ref = spec.reference(config["reference"])
    kappa = prob.get("kappa")
    return ref.Problem(n=prob["elements"], coef=tuple(coef),
                       kappa=None if kappa is None else tuple(kappa),
                       diagonal=prob.get("diagonal", "right"))


def shifted_sum(z: torch.Tensor, lo: int, hi: int, offsets, coeff):
    """sum_k coeff(k, lo, hi) z[p + off_k] on rows [lo, hi) in f64, z 0
    outside the grid; coeff gives a float or a slab of planes."""
    m = z.shape[1]
    zl, zh = max(lo - 1, 0), min(hi + 1, z.shape[0])
    zp = F.pad(z[zl:zh].to(torch.float64),
               (1, 1, 1, 1, 1 - (lo - zl), 1 - (zh - hi)))
    out = None
    for k, (ox, oy, oz) in enumerate(offsets):
        term = coeff(k, lo, hi) * zp[1 + ox:1 + ox + hi - lo,
                                     1 + oy:1 + oy + m, 1 + oz:1 + oz + m]
        out = term if out is None else out + term
    return out


class PortSystem:
    """multigrid_dolfinx_tpu_torch: the configuration's hierarchy built by
    its public builder, requests through its public solve entry."""

    def __init__(self, config: dict, traffic: dict, device):
        import multigrid_dolfinx_tpu_torch as T

        self.T, self.config, self.traffic = T, config, traffic
        self.device = torch.device(device)
        cyc = dict(config["cycle"])
        cyc["fusion"] = tuple(cyc.get("fusion", ()))
        self.cycle = T.CycleSpec(**cyc)
        hs, prob = config["hierarchy"], config["problem"]
        levels = dict(finest_level=hs["finest_level"],
                      coarsest_level=hs["coarsest_level"],
                      coarsest_elements=hs["coarsest_elements"],
                      dtype=config["dtype"], cycle=self.cycle)
        kappa = prob.get("kappa")
        if kappa is None:
            self.base = T.models.poisson3d(**levels)
            self.builder = T.build_lean_hierarchy
        else:
            k0, kx, ky, kz = kappa
            self.base = T.models.variable_coefficient_3d(
                lambda x, y, z: k0 + kx * x + ky * y + kz * z, **levels)
            self.builder = T.build_var_hierarchy
        n = hs["coarsest_elements"] * 2 ** hs["finest_level"]
        if n != prob["elements"]:
            raise ValueError(f"levels give {n} elements, the problem says "
                             f"{prob['elements']}")

    def build(self, coef):
        a, b, c = coef
        problem = dataclasses.replace(
            self.base.problem,
            exact=lambda x, y, z: 1.0 + a * x * x + b * y * y + c * z * z,
            rhs_const=-2.0 * (a + b + c))
        return self.builder(dataclasses.replace(self.base, problem=problem),
                            device=self.device)

    def request(self, hier) -> Answer:
        entry = self.traffic["entry"]
        if entry == "solve":
            r = self.T.solve(hier, self.cycle)
            return Answer(r.u, r.num_cycles, r.converged)
        if entry == "solve_mgcg":
            r = self.T.solve_mgcg(hier, self.cycle,
                                  fmg_start=self.traffic["fmg_start"])
            return Answer(r.u, r.num_iters, r.converged)
        raise ValueError(f"unknown entry {entry!r}")

    def finest(self, hier) -> Finest:
        lv = hier.finest
        A = lv.A
        if A.planes is not None:
            def coeff(k, lo, hi):
                return A.planes[k][lo:hi].to(torch.float64)
        elif A.const_weights is not None:
            def coeff(k, lo, hi):
                return float(A.const_weights[k])
        else:
            raise ValueError("finest operator is neither planes nor a "
                             "constant stencil")
        return Finest(lv.b, lv.g, lambda z, lo, hi: shifted_sum(
            z, lo, hi, A.offsets, coeff))


class ReferenceSystem:
    """The plain reference in the program's place, computed in `dtype`
    (the control): its b and g rounded to dtype, its operator applied in
    dtype, its solve the reference's multigrid in dtype."""

    def __init__(self, config: dict, traffic: dict, device,
                 dtype=torch.bfloat16):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.dtype = dtype
        self.ref = spec.reference(config["reference"])

    def build(self, coef):
        p = reference_problem(self.config, coef)
        n = p.n
        b = torch.cat([self.ref.rhs_slab(p, lo, min(lo + 32, n + 1),
                                         self.device)
                       for lo in range(0, n + 1, 32)]).to(self.dtype)
        g = self.ref.dirichlet(p, 0, n + 1, self.dtype, self.device)
        return (p, b, g)

    def request(self, hier) -> Answer:
        p = hier[0]
        cyc = self.config["cycle"]
        u, k = self.ref.solve_mg(p, self.dtype, self.device, cyc["rtol"],
                                 cyc["max_cycles"])
        return Answer(u, k, k < cyc["max_cycles"])

    def finest(self, hier) -> Finest:
        p, b, g = hier

        def apply_op(z, lo, hi):
            elo, ehi = max(lo - 1, 0), min(hi + 1, p.n + 1)
            rows = self.ref.stiffness_rows(p, z[elo:ehi].to(self.dtype), elo)
            return rows[lo - elo:hi - elo]
        return Finest(b, g, apply_op)


SYSTEMS = {"port": PortSystem, "control": ReferenceSystem}
