"""Distribution of the port over torch.distributed: the z-slab 3D solve
(`halo3d`) and the row-strip 2D solve (`halo`) on the process-group layer
of `comm`, and `run_ranks`, the launcher that spawns one process per
rank."""
from .comm import SlabComm, run_ranks
from .halo import build_halo_cycler, build_halo_solver, pick_shard_pad_plan
from .halo3d import (HaloHierarchy, ZPlan, build_halo_cycler3d,
                     build_halo_hierarchy, build_halo_mgcg3d,
                     build_halo_resume3d, build_halo_solver3d,
                     gather_solution, halo_extend_z,
                     make_distributed_jacobi_smoother,
                     make_distributed_rb_smoother, pick_z_shard_plan)

__all__ = [
    "SlabComm", "run_ranks", "HaloHierarchy", "ZPlan",
    "build_halo_cycler", "build_halo_solver", "pick_shard_pad_plan",
    "build_halo_cycler3d", "build_halo_hierarchy", "build_halo_mgcg3d",
    "build_halo_resume3d", "build_halo_solver3d", "gather_solution",
    "halo_extend_z", "make_distributed_jacobi_smoother",
    "make_distributed_rb_smoother", "pick_z_shard_plan",
]
