"""Cycle counts of the JAX package's plain path (use_pallas=False) for 2D
variable-kappa diffusion, the counts the PyTorch port's card run is held
to (chip_smoke.py, JAX_COUNTS_2049).

models.variable_coefficient_2d(kappa = 1 + x + 2y, coarsest_level 0,
coarsest_elements 8) through build_var_hierarchy (Galerkin), FMG +
V(2,2) tolerance solve with P^T, in f32 to rtol 1e-5 and in f64 to rtol
1e-8, with multicolour GS ('rbgs') and weighted Jacobi.  Runs on the CPU
(f64 enabled).  Prints one JSON line per run.

Usage: python scripts/var2d_jax_counts.py [FINEST_LEVEL]   (default 8:
2049^2)
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from multigrid_dolfinx_tpu import build_var_hierarchy, models, solve  # noqa: E402
from multigrid_dolfinx_tpu.config import CycleSpec  # noqa: E402

finest = int(sys.argv[1]) if len(sys.argv) > 1 else 8
for dtype, rtol in (("float32", 1e-5), ("float64", 1e-8)):
    for smoother in ("rbgs", "jacobi"):
        cyc = CycleSpec(nu1=2, nu2=2, smoother=smoother, restriction="pt",
                        tol=0.0, rtol=rtol, max_cycles=40,
                        track_error=False, use_pallas=False)
        cfg = models.variable_coefficient_2d(
            lambda x, y: 1.0 + x + 2.0 * y, finest_level=finest,
            coarsest_level=0, coarsest_elements=8, dtype=dtype, cycle=cyc)
        t0 = time.time()
        res = solve(build_var_hierarchy(cfg), cyc)
        k = int(res.num_cycles)
        lm = 8 * 2 ** finest + 1
        print(json.dumps({
            "lm": lm, "dtype": dtype, "smoother": smoother, "rtol": rtol,
            "cycles": k, "converged": bool(res.converged),
            "res_hist": [float(x) for x in res.res_hist[:k]],
            "u_mid": float(res.u[lm // 2, lm // 2]),
            "seconds": time.time() - t0}), flush=True)
