"""The PyTorch port's distributed 3D z-slab solve over NCCL, one card per
rank: the multi-card shape of chip_smoke.py's phase 25 (which runs its
ranks on one card over gloo).

Spawns RANKS ranks (parallel.run_ranks, backend 'nccl', rank r on
cuda:r) and runs chip_smoke.dist_main on each: poisson3d(FINEST_LEVEL,
coarsest_level 0, coarsest_elements 8) f32, FMG + V(2,2) red-black to
rtol 1e-8, (G2) MG-CG from FMG, a Jacobi V(2,2) solve to 1e-6, 10
V-cycles timed and split into kernel and halo / collective time, one
halo exchange timed alone.  Then solves the same problem on cuda:0 alone
and compares the gathered u with it (0 expected: the cycle is bitwise).
Prints the card's name and power limit, one line per rank and a JSON
line; exits nonzero on any failure or with fewer cards than ranks.
Imports nothing of JAX.

Usage: python3 scripts/halo3d_nccl.py [RANKS] [FINEST_LEVEL]
(defaults 4 and 6: 512^3 elements over 4 cards)
"""
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def rank_main(rank, world_size, device, out_dir, finest_level):
    import torch
    import torch.distributed as dist

    import multigrid_dolfinx_tpu_torch as mg

    torch.set_num_threads(2)
    u, rec = chip_smoke.dist_main(torch, dist, mg, finest_level)
    torch.save(u.cpu(), Path(out_dir) / f"u_rank{rank}.pt")
    rec["device"] = str(device)
    return rec


def main() -> int:
    import torch

    import multigrid_dolfinx_tpu_torch as mg
    from multigrid_dolfinx_tpu_torch.ops.cuda import build

    ranks = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    finest = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    if not torch.cuda.is_available() or torch.cuda.device_count() < ranks:
        print(f"FAILED: {ranks} CUDA cards needed")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    build.library()                 # once, before the ranks load it
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        recs = mg.run_ranks(rank_main, ranks, "nccl", "cuda",
                            args=(str(tmp), finest), timeout=900)
        u_p = torch.cat([torch.load(tmp / f"u_rank{r}.pt")
                         for r in range(ranks)])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cyc = chip_smoke.cycle_spec(mg, 1e-8)
    cfg = mg.models.poisson3d(finest_level=finest, coarsest_level=0,
                              coarsest_elements=8, dtype="float32", cycle=cyc)
    one = mg.solve(mg.build_lean_hierarchy(cfg, device="cuda:0"), cyc)
    lm = one.u.shape[0]
    du = float((u_p[:lm] - one.u.cpu()).abs().max())
    for r, rec in enumerate(recs):
        print(f"rank {r} ({rec['device']}): {rec['solve']['count']} cycles "
              f"(converged {rec['solve']['converged']}), MG-CG "
              f"{rec['mgcg']['count']}, Jacobi {rec['jacobi']['count']}; "
              f"{rec['ms_per_vcycle']:.4f} ms a V-cycle (instrumented "
              f"{rec['instrumented_ms']:.4f}: kernels {rec['kernel_ms']:.4f},"
              f" halo and collectives {rec['comm_ms']:.4f} in "
              f"{rec['comm_calls']} calls); one exchange "
              f"{rec['exchange_ms']}; peak {rec['peak_gb']:.2f} GB")
    m = recs[0]
    u_mid = next(r["u_mid"] for r in recs if r["u_mid"] is not None)
    ok = (m["solve"]["converged"] and m["solve"]["count"] == one.num_cycles
          and du == 0.0 and m["mgcg"]["converged"]
          and m["jacobi"]["converged"])
    print(json.dumps({"ok": ok, "ranks": ranks, "lm": lm,
                      "cycles": m["solve"]["count"],
                      "single_device_cycles": one.num_cycles,
                      "max_abs_du": du, "u_mid": u_mid,
                      "ms_per_vcycle": max(r["ms_per_vcycle"] for r in recs),
                      "kernel_ms": [r["kernel_ms"] for r in recs],
                      "comm_ms": [r["comm_ms"] for r in recs],
                      "exchange_ms": [r["exchange_ms"] for r in recs],
                      "peak_gb": [r["peak_gb"] for r in recs],
                      "card": smi.stdout.strip().splitlines()[0]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
