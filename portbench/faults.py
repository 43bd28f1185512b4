"""Faults planted underneath a whole run, each of which has to make
`correct` false: the timed path broken in a way a faster program could
break it.  Not part of a benchmark run; used by portbench/tests/ on the
CPU and by `control.py --fault` at a cell's own size on the card.

- unchanged_cycle: a V-cycle that returns its iterate unchanged;
- altered_answer: an answer altered at one node where it is produced;
- no_cycle_after_fmg: the solve stops after the FMG start, before its
  first V-cycle (solve) or CG iteration (solve_mgcg), and reports
  converged, as a loosened or skipped check would.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from portbench.harness.systems import PortSystem


@contextlib.contextmanager
def patched(*triples):
    """setattr(owner, name, new) for each triple, undone on exit."""
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in triples]
    try:
        for owner, name, new in triples:
            setattr(owner, name, new)
        yield
    finally:
        for owner, name, old in reversed(saved):
            setattr(owner, name, old)


def unchanged_cycle():
    from multigrid_dolfinx_tpu_torch.solver import fmg, krylov

    def unchanged(hier, spec_, lidx, v, f, collect_debug=False):
        return (v, None) if collect_debug else v
    return patched((fmg, "vcycle", unchanged), (krylov, "vcycle", unchanged))


def altered_answer():
    request = PortSystem.request

    def altered(self, hier):
        ans = request(self, hier)
        u = ans.u.clone()
        m = u.shape[0] // 2
        u[m, m, m] += 1e-2
        return ans._replace(u=u)
    return patched((PortSystem, "request", altered))


def no_cycle_after_fmg():
    import multigrid_dolfinx_tpu_torch as T
    from multigrid_dolfinx_tpu_torch.solver import fmg, krylov

    def no_cycle(hier, spec_, v0, f):
        nan = torch.full((spec_.max_cycles,), float("nan"), dtype=v0.dtype,
                         device=v0.device)
        return fmg.SolveResult(u=v0, res_hist=nan, err_hist=nan.clone(),
                               num_cycles=0, converged=True, diverged=False)

    def fmg_start_only(hier, spec_, fmg_start=True):
        x = krylov.fmg_ramp(hier, dataclasses.replace(spec_, mu0=1))[0]
        nan = torch.full((spec_.max_cycles,), float("nan"), dtype=x.dtype,
                         device=x.device)
        return krylov.CGResult(u=x, res_hist=nan, num_iters=0,
                               converged=True, diverged=False)
    return patched((fmg, "tolerance_solve", no_cycle),
                   (T, "solve_mgcg", fmg_start_only))


FAULTS = {"unchanged_cycle": unchanged_cycle,
          "altered_answer": altered_answer,
          "no_cycle_after_fmg": no_cycle_after_fmg}
