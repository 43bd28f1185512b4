"""The rank side of tests/test_torch_halo2d.py: every distributed 2D
configuration of the test file, run in one spawn of 3 ranks (the 2-rank
runs on a subgroup; multigrid_dolfinx_tpu_torch.parallel.run_ranks).
Imports torch and the port only, so a spawned rank starts without JAX."""
import torch

import multigrid_dolfinx_tpu_torch as T
from multigrid_dolfinx_tpu_torch.parallel import SlabComm, halo

#: name -> cycle options: the configurations of the test file, each at
#: 32^2 elements (levels 9, 17, 33), f64.
CONFIGS = {
    "rbgs": dict(smoother="rbgs", restriction="pt", rtol=1e-9),
    "jacobi": dict(smoother="jacobi", restriction="pt", rtol=1e-9),
    "chebyshev": dict(smoother="chebyshev", restriction="pt", rtol=1e-9),
    "injection": dict(smoother="jacobi", restriction="injection", rtol=0.0,
                      max_cycles=4),
    "abs_tol": dict(smoother="rbgs", restriction="pt", tol=2e-7, rtol=0.0),
}
#: cycles of build_halo_cycler's run
CYCLES = 2


def cycle_options(name, **override):
    """The CycleSpec options of configuration `name` (either package)."""
    opts = dict(nu1=2, nu2=2, tol=0.0, max_cycles=40, track_error=False)
    opts.update(CONFIGS[name])
    opts.update(override)
    return opts


def config(name, **override):
    cyc = T.CycleSpec(**cycle_options(name, **override))
    return T.models.poisson2d(finest_level=2, coarsest_level=0,
                              coarsest_elements=8, dtype="float64",
                              cycle=cyc)


def _record(hier, res, group):
    u = T.gather_solution(hier, res.u, group)
    return {"count": res.num_cycles, "converged": res.converged,
            "hist": res.res_hist.cpu().numpy(),
            "u": u.cpu().numpy() if hier.rank == 0 else None}


def run_configs(rank, world_size, device, sizes):
    """Every configuration on the first P ranks for each P in `sizes`
    (the whole world, or a subgroup of ranks 0 .. P-1), one build of the
    rank's levels serving them all (none changes the Jacobi weight or
    the Chebyshev degree, the only cycle options a build reads); then
    the reference's run (models.poisson2d()) on the whole world.  Returns
    {P: {name: record, "cycler": gathered u, "strips": this rank's b and
    g per level}, "reference": record}, the gathered u in rank 0's
    records."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    out = {}
    for P in sizes:
        group = None if P == world_size else dist.new_group(list(range(P)))
        if rank >= P:
            continue
        hier = halo.build_row_hierarchy(config("rbgs"), SlabComm(group),
                                        device)
        res = {}
        for name in CONFIGS:
            _, fn = T.build_halo_solver(config(name), group, device, hier)
            res[name] = _record(hier, fn(hier), group)
        _, cycles = T.build_halo_cycler(config("rbgs"), CYCLES, group,
                                        device, hier)
        u = cycles(hier, torch.zeros_like(hier.finest.b))
        res["cycler"] = T.gather_solution(hier, u, group).cpu().numpy()
        res["strips"] = {"b": [lv.b.cpu().numpy() for lv in hier.levels],
                         "g": [lv.g.cpu().numpy() for lv in hier.levels]}
        out[P] = res
    ref = T.models.poisson2d()
    hier, fn = T.build_halo_solver(ref, device=device)
    out["reference"] = _record(hier, fn(hier), None)
    return out
