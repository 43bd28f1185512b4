"""The rank side of tests/test_torch_halo3d.py: every distributed
configuration of the test file, run in one spawn of 4 ranks (the 2-rank
runs on a subgroup; multigrid_dolfinx_tpu_torch.parallel.run_ranks).
Imports torch and the port only, so a spawned rank starts without JAX."""
import numpy as np
import torch

import multigrid_dolfinx_tpu_torch as T
from multigrid_dolfinx_tpu_torch.ops import dispatch
from multigrid_dolfinx_tpu_torch.parallel import SlabComm, halo3d
from multigrid_dolfinx_tpu_torch.utils.convert import halo_slab_from_numpy

#: name -> (cycle options, entry): the configurations of the test file,
#: each at 32^3 elements (levels 9, 17, 33), f64.
CONFIGS = {
    "rbgs": (dict(nu1=2, nu2=2, smoother="rbgs", restriction="pt",
                  rtol=1e-8), "solve"),
    "jacobi": (dict(nu1=2, nu2=2, smoother="jacobi", restriction="pt",
                    rtol=1e-8), "solve"),
    "chebyshev": (dict(nu1=2, nu2=2, smoother="chebyshev", restriction="pt",
                       rtol=1e-8), "solve"),
    "injection": (dict(nu1=2, nu2=2, smoother="jacobi",
                       restriction="injection", rtol=0.0, max_cycles=4),
                  "solve"),
    "mgcg": (dict(nu1=2, nu2=2, smoother="rbgs", restriction="pt",
                  rtol=1e-10), "mgcg"),
    "resume": (dict(nu1=2, nu2=2, smoother="rbgs", restriction="pt",
                    rtol=1e-8), "resume"),
}


def cycle_options(name, **override):
    """The CycleSpec options of configuration `name` (either package)."""
    opts = dict(tol=0.0, max_cycles=40, track_error=False)
    opts.update(CONFIGS[name][0])
    opts.update(override)
    return opts


def config(name, finest_level=2, dtype="float64", **override):
    cyc = T.CycleSpec(**cycle_options(name, **override))
    return T.models.poisson3d(finest_level=finest_level, coarsest_level=0,
                              coarsest_elements=8, dtype=dtype, cycle=cyc)


def _record(hier, res, count, group):
    u = T.gather_solution(hier, res.u, group)
    return {"count": count, "converged": res.converged,
            "hist": res.res_hist.double().cpu().numpy(),
            "u": u.cpu().numpy() if hier.rank == 0 else None}


def _run(name, device, group, hier):
    """Configuration `name` on the rank's levels `hier` (one build serves
    every configuration: none of them changes the Jacobi weight or the
    Chebyshev degree, the only cycle options a build reads)."""
    kind = CONFIGS[name][1]
    cfg = config(name)
    if kind == "solve":
        _, fn = T.build_halo_solver3d(cfg, group, device, hier)
        res = fn(hier)
        return _record(hier, res, res.num_cycles, group)
    if kind == "mgcg":
        _, fn = T.build_halo_mgcg3d(cfg, group, device, hier)
        res = fn(hier)
        return _record(hier, res, res.num_iters, group)
    # resume from the state after one cycle
    _, fn = T.build_halo_solver3d(config(name, max_cycles=1), group, device,
                                  hier)
    part = fn(hier)
    _, resume = T.build_halo_resume3d(cfg, group, device, hier)
    res = resume(hier, part.u, part.num_cycles, part.res_hist)
    return _record(hier, res, res.num_cycles, group)


def entry_point_inputs(lm):
    """The seeded global v and f the smoother entry points sweep."""
    rng = np.random.default_rng(7)
    return rng.standard_normal((2, lm, lm, lm))


def _entry_points(device, group, hier):
    """make_distributed_rb_smoother / _jacobi_smoother (2 sweeps each) on
    the finest slabs of entry_point_inputs, halo_extend_z of v (2-deep),
    and build_halo_cycler3d's 2 V-cycles from zero, gathered."""
    _, cycles = T.build_halo_cycler3d(config("rbgs"), 2, group, device,
                                      hier)
    L = hier.num_levels - 1
    lm = hier.plan.lms[L]
    wc, woff = dispatch.const7_weights(hier.levels[L].A)
    v, f = (torch.from_numpy(halo_slab_from_numpy(a, hier.plan, L, hier.rank))
            .to(device) for a in entry_point_inputs(lm))
    rb = halo3d.make_distributed_rb_smoother(lm, wc, woff, 2, group)
    jac = halo3d.make_distributed_jacobi_smoother(lm, wc, woff, 2.0 / 3.0, 2,
                                                  group)
    out = {"rb": rb(v, f), "jacobi": jac(v, f),
           "cycles": cycles(hier, torch.zeros_like(hier.finest.b))}
    out = {k: T.gather_solution(hier, x, group).cpu().numpy()
           for k, x in out.items()}
    out["extended"] = halo3d.halo_extend_z(v, 2, group).cpu().numpy()
    return out


def run_configs(rank, world_size, device, names, sizes):
    """Every named configuration on the first P ranks for each P in
    `sizes` (the whole world, or a subgroup of ranks 0 .. P-1); returns
    {P: {name: record, "slabs": this rank's b and g per level}}, with the
    gathered u in rank 0's records."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    out = {}
    for P in sizes:
        group = None if P == world_size else dist.new_group(list(range(P)))
        if rank >= P:
            continue
        hier = halo3d.build_halo_hierarchy(config("rbgs"),
                                           SlabComm(group), device)
        res = {name: _run(name, device, group, hier) for name in names}
        res["entry_points"] = _entry_points(device, group, hier)
        res["slabs"] = {"b": [lv.b.cpu().numpy() for lv in hier.levels],
                        "g": [lv.g.cpu().numpy() for lv in hier.levels]}
        out[P] = res
    return out
