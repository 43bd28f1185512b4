#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--out DIR]

Phases (each prints one line; any failure exits nonzero with no result):
  1. the device: torch's name for it, and nvidia-smi's name and power limit;
  2. build of the CUDA kernels from multigrid_dolfinx_tpu_torch/csrc;
  3. each 3D kernel (K1-K4) against its plain PyTorch version on the card,
     on inputs from numpy's default_rng, at lm in {9, 17, 65, 129, 257,
     513}, and kernel / plain times at the main path's 513^3 / 257^3
     shapes;
  4. the 3D slice at 64^3 f32 on the card against the plain path on the
     CPU;
  5. the 3D main path: 512^3 f32 lean FMG + V(2,2) solve to rtol 1e-8,
     with every kernel's launches counted, and 10 V-cycles timed with CUDA
     events;
  6. each 2D kernel (K5-K9) against its plain version in f32 and f64 at
     lm in {9, 17, 65, 257, 1025, 2049, 8193}, and kernel / plain times
     at 8193^2 f32;
  7. the reference's exact run, models.poisson2d() in f64 through the
     assembled build_hierarchy (V(50,50) weighted Jacobi, injection):
     63 cycles on the card, histories equal to the plain path on the CPU;
  8. the 2D production configuration at 2049^2 f32 (lean, V(2,2)
     red-black, P^T) on the card against the plain path on the CPU;
  9. the 2D production configuration at full width, 8193^2 f32, 11
     levels, to rtol RTOL_2D, with its launches counted, 10 V-cycles
     timed, and the f32 residual floor read from 6 more cycles; then the
     same configuration in f64, whose u(1/2,1/2) must lie within 1e-2 of
     1.75;
 10. K10-K12 (residual, jacobi_sweep, cheby_step) against their plain
     versions in f32 and f64 at lm in KERNEL_LMS, bitwise, and kernel /
     plain times at 513^3 f32;
 11. (C) Chebyshev V(2,2) and (G1) zero-start MG-CG with the V(1,1)
     Jacobi preconditioner at 64^3 f32 on the card against the plain path
     on the CPU;
 12. BASELINE configurations 3 and 5 at 512^3 f32: (C) FMG + V(2,2)
     Chebyshev to rtol 1e-8; (G1) zero-start MG-CG with V(1,1) Jacobi to
     rtol 1e-6 beside the plain V-cycle loop from zero with the same
     cycle, and the same MG-CG from an FMG start; (G2) FMG-start MG-CG
     with V(2,2) red-black to rtol 1e-8; each with launches, peak memory,
     u(1/2,1/2,1/2), the FEM-L2 error and ms per V-cycle or per MG-CG
     iteration.  Every run holds u(1/2,1/2,1/2) within 1e-2 of 2.5, and
     (G1) from zero runs once more in f64 beside the f32 run;
 13. the fused coarse tail (K13 tail_down, K14 tail_up) against its plain
     version (the per-level plain K1-K3 sequence) in f32 and f64 on the
     tails of the 512^3 hierarchy (tops 17, 33, 65), bitwise; kernel /
     plain times on the 65^3-topped tail; and the V-cycle rooted at 65^3
     and 129^3 with and without the tail;
 14. the stored-planes kernels K15-K17 (residual, Jacobi, multicolour GS)
     against their plain versions in f32 and f64 at lm in PLANES_LMS on
     random planes with the 15 Kuhn, 27 Galerkin, 7 axis and 25 radius-2
     offsets, and K18 (P^T of a given residual) at lm -> (lm+1)/2, all
     bitwise; kernel / plain times at 385^3 f32 (15 offsets; K18 to
     193^3); and the Galerkin planes of a 129^3 variable-kappa hierarchy
     against the CPU's f64 build: each RAP step on the card in f32 within
     1e-6 (TF32 would miss it by ~1e-3), the card's whole f32 build within
     1e-6 per RAP step below the finest;
 15. the variable-kappa slice at 64^3 f32 (Galerkin, V(2,2), rbgs and
     jacobi): the hierarchy built on the CPU and carried to the card
     solves with res_hist bitwise the CPU's, the card-built one in the
     same number of cycles;
 16. scripts/bench_var_scale.py's configuration at 384^3 f32 (kappa = 1 +
     x + 2y + z, 5 levels 25^3 to 385^3, Galerkin, V(2,2) multicolour GS,
     P^T, FMG + tolerance solve to rtol 1e-6): build and coarse-factor
     seconds, cycles, 10 V-cycles timed, launches, peak memory and
     u(1/2,1/2,1/2); K15-K18 and K3 on every level of that hierarchy (its
     own planes and b, lm 385 ... 25) and of the f64 one, bitwise against
     their plain versions; a Jacobi tolerance solve on the same
     hierarchy; a witness, the f64 solve on the f32 build's operator
     (planes, b and g cast up), whose u the f32 run must meet within 1e-4
     everywhere; the same configuration in f64, whose u(1/2,1/2,1/2) the
     witness must meet within 1.2e-3 (f32 rounding of the operator);
 17. the P2 kernels K19-K21 (residual, snap Jacobi, raw mass quadratic
     form) against their plain versions in f32 and f64 at lattices
     P2_LMS, on seeded random v and f with each lattice's own parity
     tables, bitwise; kernel / plain times at 513^3 f32;
 18. the P2 slice at the 65^3 lattice in f32 (V(2,2) snap Jacobi, rtol
     1e-6): the hierarchy built on the CPU and carried to the card solves
     in the CPU's cycle count with res_hist within RTOL_P2_SMALL of the
     CPU's (bitwise expected), the card-built one in the same count;
 19. BASELINE config 4's constant-coefficient P2 path at full width
     (scripts/bench_p2_solve.py 256's configuration, storage unpadded:
     6 levels, lattices 17^3 ... 513^3, f32, FMG + V(2,2) snap Jacobi to
     rtol 2e-8, then MG-CG from FMG on the same hierarchy): build and
     coarse-factor seconds, cycles, iterations, 10 V-cycles timed, the
     check timed, launches, peak memory, u(1/2,1/2,1/2) (within 1e-2 of
     2.5) and max|u - u*| over the nodes, also after 4 more cycles and in
     an f64 twin; no plain kernel version runs on the card during either
     path;
 20. the 2D stored-planes kernels K22-K24 (residual, Jacobi, multicolour
     GS) against their plain versions in f32 and f64 at lm in
     PLANES2_LMS on random planes with the 5 axis ('sum' colours), 7 P1
     and 9 Galerkin ('quad') and 13 radius-2 ('mod'; lm <= 4097)
     offsets, bitwise; kernel / plain times at 8193^2 f32 (7 offsets, the
     finest level) and 4097^2 f32 (9 offsets, the level below);
 21. 2D variable kappa (models.variable_coefficient_2d, kappa = 1 + x +
     2y, Galerkin, V(2,2) multicolour GS, P^T) at 2049^2 on the card
     against the plain path on the CPU, f32 to rtol 1e-5 and f64 to rtol
     1e-8, each count equal to the JAX package's (JAX_COUNTS_2049); the
     Jacobi variant on the card, held to the JAX package's counts too;
 22. the same configuration at full width, 8193^2 f32, 11 levels, to
     rtol RTOL_2D: build seconds, cycles, launches, peak memory, 10
     V-cycles timed (rooted per level), the check timed, the f32 floor
     from 6 more cycles; K22-K24, K8 and K9 on every level of that
     hierarchy (its own planes and b) and of the f64 one, bitwise against
     their plain versions; the Jacobi variant and MG-CG from FMG on the
     same hierarchy; an f64 twin with u(1/2,1/2) and max|u_f32 - u_f64|;
     no plain kernel version runs on the card during the f32 paths;
 23. the z-slab kernels K25-K29 of the distributed 3D path (red-black,
     Jacobi, residual, residual + P^T, prolongation + correction) against
     their plain versions on every rank's block of global lm in DIST_LMS
     split over 2 and 4 ranks as the port's plan splits them, the main
     path's (136, 513, 513) blocks among them (edge and interior ranks,
     plan padding rows included), f32 and f64, bitwise; the blocks' outputs stitched
     together bitwise the single-device K1, K11, K10, K2 and K3 on the
     same global data; kernel / plain times at DIST_TIMED in f32;
 24. the distributed 3D solve at 64^3 f32 over 2 ranks (gloo, both on
     the card) against the same ranks on the CPU with the plain
     versions: equal counts, histories within 1e-5, u compared (V(2,2)
     red-black to rtol 1e-7, MG-CG from FMG to 1e-6);
 25. the distributed 3D main path at full width, 512^3 f32, over
     DIST_RANKS ranks sharing the card over gloo (spawned with
     parallel.run_ranks, the library built by phase 2): FMG + V(2,2)
     red-black to rtol 1e-8, (G2) MG-CG from FMG and an FMG-started
     V(2,2) Jacobi solve to 1e-6, with K25-K29 launches per rank, peak
     memory per rank, 10 V-cycles timed and split into kernel time (CUDA
     events) and halo / collective wall time, one halo exchange timed
     alone; each rank's slab comes back through a file and must equal
     phase 5's single-device u exactly, in the same cycle count, with
     u(1/2,1/2,1/2) within 1e-2 of 2.5;
 26. the row-strip kernels K30-K34 of the distributed 2D path (red-black,
     Jacobi, residual, P^T restriction, prolongation + correction)
     against their plain versions on every rank's strip of global lm in
     DIST2D_LMS split over 2 and 4 ranks as the port's plan splits them
     (edge and interior ranks, padding rows, a rank of 65^2 over 4 that
     holds only padding), f32 and f64, bitwise; the strips' outputs
     stitched together bitwise the single-device K6, K5, K7, K8 and
     v + K9 on the same global data; kernel / plain / library times at a
     rank's finest strip of (D2) in f32;
 27. the distributed 2D solve at 2049^2 f32 over 2 ranks (gloo, both on
     the card) against the same ranks on the CPU with the plain versions
     (V(2,2) red-black and Jacobi to RTOL_2D: equal counts, histories
     within 1e-5, u bitwise), and the reference's run distributed over
     the 2 ranks on the card: exactly 63 cycles;
 28. (D2), the distributed 2D path at full width, 8193^2 f32 (11 levels)
     over DIST_RANKS ranks sharing the card over gloo: FMG + V(2,2)
     red-black to RTOL_2D and a Jacobi V(2,2) solve beside the same
     solve single-device on the card, with K30-K34 launches, build
     seconds and peak memory per rank, 10 V-cycles timed and split into
     kernel and halo / collective time, one exchange timed alone; each
     rank's strip comes back through a file and must equal phase 9's u
     (and the single-device Jacobi u) exactly, in the same cycle count;
 29. the red-black half sweep (K1's kernel, one colour) and the fusion
     kernels K35-K37 (two sweeps; a sweep + residual + P^T; the
     correction + a sweep) against their plain versions and against the
     unfused CUDA chains they replace (two half sweeps = K1, K1 twice, K1
     then K2, K3 then K1), bitwise, in f32 and f64 at lm in KERNEL_LMS;
     kernel, plain and unfused-chain times at 513^3 f32;
 30. (a) phase 5's configuration with each CycleSpec.fusion set of
     FUSION_SETS: phase 5's cycle count, u bitwise phase 5's, exactly the
     fused kernels each set must run launched, and ms a V-cycle of each
     set beside the unfused cycle, in turns; (b) 64^3 f32 with every
     fusion on the card: res_hist and u bitwise the plain path's on the
     CPU; (c) W(2,2) and F(2,2) at 512^3 f32 with every fusion: converged,
     u(1/2,1/2,1/2) within 1e-2 of 2.5, cycles and ms a cycle;
 31. K38 (residual_mass_quad, the residual and r^T M r for any radius-1
     class-table mass) against its plain version within TOL_NORM, two
     calls bitwise equal, in f32 and f64 at lm in KERNEL_LMS on seeded
     random v and f with the P1 mass tables of both diagonals (there also
     against K4 within TOL_NORM) and, at lm <= 65, a random symmetric
     27-offset table; kernel / plain times at 513^3 f32 beside K4's;
 32. phase 5's configuration with the mass uncertified (uniform_p1_mass
     None, the StencilOperator default a carried-across JAX hierarchy may
     hold), so the check runs on K38: phase 5's cycle count, u bitwise
     phase 5's, res_hist within TOL_NORM of phase 5's, K38 launched once a
     check and K4 never; the check timed on both masses.
Each main path (5, 7, 9, each run of 12, 16, 19, 22, 25, 28, 30 and 32) sets the
launch counts to 0 just before it runs and reads them just after.  Each kernel's record
carries its time, its plain version's, the time of one PyTorch call that
computes the same function where there is one (library_ms, else null;
never called by the port) and its bound: the larger of the bytes it must
move over 3.35 TB/s and its f32 operations over 67 TFLOP/s (H100 SXM).
Before them a line gives each phase's wall seconds.  The second-to-last
line is the kernels' JSON record (K1-K38 and the half sweep, each with the
launches of the main path that runs it; phase 30's summed for the half
sweep and K35-K37, phase 32's for K38), the last line {"ok": true,
"device": {...}}.  nvcc's report and the full record go to --out (default
build/chip_smoke/, under the checkout).  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
KERNEL_LMS = (9, 17, 65, 129, 257, 513)
TIMED_LM = 513            # the main path's finest level (512^3 elements)
KERNEL_LMS_2D = (9, 17, 65, 257, 1025, 2049, 8193)
TIMED_LM_2D = 8193        # the 2D production finest level (8192^2 elements)
FINEST_LEVEL_2D = 10      # 8 * 2^10 = 8192 elements per axis, 11 levels
# rtol of the 8193^2 f32 solve: the smallest power of ten above the f32
# residual floor there, ~3.2e-6 of ||b||_M on an H100 (phase 9 prints it).
RTOL_2D = 1e-5
TPU_KERNELS = {
    "rb_sweep": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:574",
    "restrict_residual_pt": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:1051",
    "prolong_linear_add": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:1209",
    "prolong_linear": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:1181",
    "residual_tet_quad": "multigrid_dolfinx_tpu/ops/pallas/stencil3d_norm.py:375",
    "jacobi_sweep_2d": "multigrid_dolfinx_tpu/ops/pallas/stencil2d.py:135",
    "rb_sweep_2d": "multigrid_dolfinx_tpu/ops/pallas/stencil2d.py:188",
    "residual_2d": "multigrid_dolfinx_tpu/ops/pallas/stencil2d.py:230",
    "restrict_pt_2d": "multigrid_dolfinx_tpu/ops/pallas/stencil2d.py:293",
    "prolong_linear_2d": "multigrid_dolfinx_tpu/ops/pallas/stencil2d.py:634",
    "residual": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:805",
    "jacobi_sweep": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:771",
    "cheby_step": "multigrid_dolfinx_tpu/ops/pallas/stencil3d_cheby.py:170",
    "tail_down": "multigrid_dolfinx_tpu/ops/pallas/stencil3d_tail.py:214",
    "tail_up": "multigrid_dolfinx_tpu/ops/pallas/stencil3d_tail.py:239",
    "planes3_residual": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:1511",
    "planes3_jacobi_sweep": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:1499",
    "planes3_gs_sweep": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:1479",
    "restrict_pt": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:903",
    "p2_residual": "multigrid_dolfinx_tpu/ops/pallas/stencil3d_p2.py:240",
    "p2_jacobi_sweep": "multigrid_dolfinx_tpu/ops/pallas/stencil3d_p2.py:247",
    "p2_mass_quad": "multigrid_dolfinx_tpu/ops/pallas/stencil3d_p2.py:429",
    "planes2_residual": "multigrid_dolfinx_tpu/ops/pallas/stencil2d.py:596",
    "planes2_jacobi_sweep": "multigrid_dolfinx_tpu/ops/pallas/stencil2d.py:544",
    "planes2_gs_sweep": "multigrid_dolfinx_tpu/ops/pallas/stencil2d.py:467",
    "rb_sweep_dist": "multigrid_dolfinx_tpu/ops/pallas/stencil3d_dist.py:257",
    "jacobi_sweep_dist": "multigrid_dolfinx_tpu/ops/pallas/stencil3d_dist.py:276",
    "residual_dist": "multigrid_dolfinx_tpu/ops/pallas/stencil3d_dist.py:293",
    "restrict_residual_pt_dist":
        "multigrid_dolfinx_tpu/ops/pallas/stencil3d_dist.py:446",
    "prolong_linear_dist":
        "multigrid_dolfinx_tpu/ops/pallas/stencil3d_dist.py:576",
    "rb_sweep_dist_2d": "multigrid_dolfinx_tpu/ops/pallas/stencil2d_dist.py:152",
    "jacobi_sweep_dist_2d":
        "multigrid_dolfinx_tpu/ops/pallas/stencil2d_dist.py:212",
    "residual_dist_2d": "multigrid_dolfinx_tpu/ops/pallas/stencil2d_dist.py:265",
    "restrict_pt_dist_2d":
        "multigrid_dolfinx_tpu/ops/pallas/stencil2d_dist.py:335",
    "prolong_add_dist_2d":
        "multigrid_dolfinx_tpu/ops/pallas/stencil2d_dist.py:406",
    "rb_half_sweep": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:430",
    "rb_sweep2": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:682",
    "rb_residual_restrict":
        "multigrid_dolfinx_tpu/ops/pallas/stencil3d_cycle.py:253",
    "prolong_correct_rb":
        "multigrid_dolfinx_tpu/ops/pallas/stencil3d_cycle.py:481",
    "residual_mass_quad":
        "multigrid_dolfinx_tpu/ops/pallas/stencil3d_norm.py:561",
}
KERNELS_3D = ("rb_sweep", "restrict_residual_pt", "prolong_linear_add",
              "prolong_linear", "residual_tet_quad")
# the kernels each 2D main path runs
KERNELS_REFERENCE = ("jacobi_sweep_2d", "residual_2d", "prolong_linear_2d")
KERNELS_2D = ("rb_sweep_2d", "residual_2d", "restrict_pt_2d",
              "prolong_linear_2d")
KERNELS_SLICE3 = ("residual", "jacobi_sweep", "cheby_step")
KERNELS_TAIL = ("tail_down", "tail_up")
KERNELS_PLANES = ("planes3_residual", "planes3_jacobi_sweep",
                  "planes3_gs_sweep", "restrict_pt")
PLANES_LMS = (9, 17, 65, 129, 257, 385)
KERNELS_P2 = ("p2_residual", "p2_jacobi_sweep", "p2_mass_quad")
P2_LMS = (9, 17, 33, 65, 129, 257, 513)
TIMED_LM_P2 = 513         # the P2 finest lattice (256^3 elements)
# the 65^3-lattice P2 solve, card vs CPU: the kernels are bitwise their
# plain versions and K21 sums in a fixed order, so res_hist is expected
# bitwise; held to one f32 ulp of relative room (the coarse solve is an f64
# library solve, rounded to f32, in another order on each device)
RTOL_P2_SMALL = 1.2e-7
TIMED_LM_VAR = 385        # the 384^3 variable-kappa finest level
KERNELS_PLANES2 = ("planes2_residual", "planes2_jacobi_sweep",
                   "planes2_gs_sweep")
PLANES2_LMS = (9, 17, 1025, 4097, 8193)
KERNELS_DIST = ("rb_sweep_dist", "jacobi_sweep_dist", "residual_dist",
                "restrict_residual_pt_dist", "prolong_linear_dist")
DIST_LMS = (17, 65, 257, 513)
# (slabs, lm) of a rank's finest block: 512^3 over 4 ranks (this check's
# distributed run) and 1024^3 over 8 (the JAX package's production shape)
DIST_TIMED = ((136, 513), (136, 1025))
DIST_RANKS = 4
DIST_TIMEOUT_S = 600      # the spawned ranks' limit (phases 24-25, 27-28)
KERNELS_DIST2D = ("rb_sweep_dist_2d", "jacobi_sweep_dist_2d",
                  "residual_dist_2d", "restrict_pt_dist_2d",
                  "prolong_add_dist_2d")
DIST2D_LMS = (17, 65, 1025, 8193)
KERNELS_CYCLE = ("rb_half_sweep", "rb_sweep2", "rb_residual_restrict",
                 "prolong_correct_rb")
# lm up to which phase 31 also runs a random 27-offset class table
MASS_GENERIC_LM = 65
# the CycleSpec.fusion sets phase 30 runs
FUSION_SETS = (("rb2",), ("rb_restrict", "prolong_rb"),
               ("rb2", "rb_restrict", "prolong_rb"))
# the 64^3 distributed run, card vs CPU: rbgs to 1e-7 (phase 4's rtol) and
# MG-CG to 1e-6 (1e-7 is below the f32 floor for MG-CG at 64^3)
RTOL_DIST_SMALL = {"solve": 1e-7, "mgcg": 1e-6}
# the 2D variable-kappa configuration's cycle counts in the JAX package's
# plain path on the CPU at 2049^2 (scripts/var2d_jax_counts.py), keyed by
# (dtype, smoother); f32 to rtol 1e-5, f64 to rtol 1e-8
JAX_COUNTS_2049 = {("float32", "rbgs"): 2, ("float32", "jacobi"): 3,
                   ("float64", "rbgs"): 3, ("float64", "jacobi"): 7}
RTOL_VAR2D = {"float32": 1e-5, "float64": 1e-8}
AXIS7 = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1),
         (0, 1, 0), (1, 0, 0))
BOX27 = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
              for c in (-1, 0, 1))
RADIUS2 = tuple((a, b, c) for a in range(-2, 3) for b in range(-2, 3)
                for c in range(-2, 3) if abs(a) + abs(b) + abs(c) <= 2)
# the tails of the 512^3 hierarchy's V-cycles (coarsest first): below the
# 33^3, 65^3 and 129^3 levels
TAIL_CHAINS = ((9, 17), (9, 17, 33), (9, 17, 33, 65))
SOURCES = {
    "rb_sweep": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "restrict_residual_pt": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "prolong_linear_add": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "prolong_linear": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "residual_tet_quad": "multigrid_dolfinx_tpu_torch/csrc/stencil3d_norm.cu",
    **{k: "multigrid_dolfinx_tpu_torch/csrc/stencil2d.cu"
       for k in ("jacobi_sweep_2d", "rb_sweep_2d", "residual_2d",
                 "restrict_pt_2d", "prolong_linear_2d")},
    "residual": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "jacobi_sweep": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "cheby_step": "multigrid_dolfinx_tpu_torch/csrc/stencil3d_cheby.cu",
    "tail_down": "multigrid_dolfinx_tpu_torch/csrc/stencil3d_tail.cu",
    "tail_up": "multigrid_dolfinx_tpu_torch/csrc/stencil3d_tail.cu",
    **{k: "multigrid_dolfinx_tpu_torch/csrc/stencil3d_planes.cu"
       for k in KERNELS_PLANES[:3]},
    "restrict_pt": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    **{k: "multigrid_dolfinx_tpu_torch/csrc/stencil3d_p2.cu"
       for k in KERNELS_P2},
    **{k: "multigrid_dolfinx_tpu_torch/csrc/stencil2d_planes.cu"
       for k in KERNELS_PLANES2},
    **{k: "multigrid_dolfinx_tpu_torch/csrc/stencil3d_dist.cu"
       for k in KERNELS_DIST},
    **{k: "multigrid_dolfinx_tpu_torch/csrc/stencil2d_dist.cu"
       for k in KERNELS_DIST2D},
    "rb_half_sweep": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    **{k: "multigrid_dolfinx_tpu_torch/csrc/stencil3d_cycle.cu"
       for k in KERNELS_CYCLE[1:]},
    "residual_mass_quad": "multigrid_dolfinx_tpu_torch/csrc/stencil3d_norm.cu",
}
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s and f32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# f32 operations per fine point (per coarse point for the '_c' entries),
# counted from each kernel's arithmetic in csrc/: the neighbour sum is 5
# adds in 3D and 3 in 2D, the const-7 residual 9, the [1 2 1] restriction
# 40 per 3D coarse point and 13 per 2D one, the per-tet norm 54 per cell;
# the planes kernels at K = 15: a multiply and an add per offset, plus 1
# (residual), 6 (Jacobi, with the division) or 4 (GS); the half sweep
# updates half the points, the fusions add up the sweeps, residual,
# restriction and prolongation they run; the class-table form 40 at the
# P1 mass's 15 offsets (the residual 9, a multiply and an add an offset,
# the product with r(p)).
OPS = {"rb_sweep": 8, "restrict_residual_pt": 9, "restrict_residual_pt_c": 40,
       "planes3_residual": 31, "planes3_jacobi_sweep": 34,
       "planes3_gs_sweep": 34, "restrict_pt": 0, "restrict_pt_c": 40,
       "prolong_linear": 3, "prolong_linear_add": 4, "residual_tet_quad": 63,
       "jacobi_sweep_2d": 8, "rb_sweep_2d": 5, "residual_2d": 6,
       "restrict_pt_2d": 0, "restrict_pt_2d_c": 13, "prolong_linear_2d": 2,
       "residual": 9, "jacobi_sweep": 11, "cheby_step": 14,
       "rb_sweep_dist": 8, "jacobi_sweep_dist": 11, "residual_dist": 9,
       "restrict_residual_pt_dist": 9, "restrict_residual_pt_dist_c": 40,
       "prolong_linear_dist": 4, "rb_sweep_dist_2d": 5,
       "jacobi_sweep_dist_2d": 8, "residual_dist_2d": 6,
       "restrict_pt_dist_2d": 0, "restrict_pt_dist_2d_c": 13,
       "prolong_add_dist_2d": 3, "rb_half_sweep": 4, "rb_sweep2": 16,
       "rb_residual_restrict": 17, "rb_residual_restrict_c": 40,
       "prolong_correct_rb": 12, "residual_mass_quad": 40}
# f32 arrays of fine points each kernel reads or writes once (fine, coarse)
ARRAYS = {"rb_sweep": (3, 0), "restrict_residual_pt": (2, 1),
          "prolong_linear": (1, 1), "prolong_linear_add": (2, 1),
          "residual_tet_quad": (2, 0), "jacobi_sweep_2d": (3, 0),
          "rb_sweep_2d": (3, 0), "residual_2d": (3, 0),
          "restrict_pt_2d": (1, 1), "prolong_linear_2d": (1, 1),
          "residual": (3, 0), "jacobi_sweep": (3, 0), "cheby_step": (4, 0),
          "planes3_residual": (18, 0), "planes3_jacobi_sweep": (18, 0),
          "planes3_gs_sweep": (18, 0), "restrict_pt": (1, 1),
          "p2_residual": (3, 0), "p2_jacobi_sweep": (3, 0),
          "p2_mass_quad": (1, 0), "rb_sweep_dist": (3, 0),
          "jacobi_sweep_dist": (3, 0), "residual_dist": (3, 0),
          "restrict_residual_pt_dist": (2, 1), "prolong_linear_dist": (2, 1),
          "rb_sweep_dist_2d": (3, 0), "jacobi_sweep_dist_2d": (3, 0),
          "residual_dist_2d": (3, 0), "restrict_pt_dist_2d": (1, 1),
          "prolong_add_dist_2d": (2, 1), "rb_half_sweep": (3, 0),
          "rb_sweep2": (3, 0), "rb_residual_restrict": (3, 1),
          "prolong_correct_rb": (3, 1), "residual_mass_quad": (2, 0)}
RTOL_64 = {"C": 1e-7, "G1": 1e-6}     # above the f32 floor at 64^3
# K1-K3 and K5-K9 must agree to 1e-6 of the reference's magnitude (bitwise is
# expected: same association order, kernels built with --fmad=false); K4
# and K38 to 1e-5 relative (their f64 sums run in another order than
# torch.sum; K38 against K4, two associations of the same form).
TOL_STENCIL = 1e-6
TOL_NORM = 1e-5
# what a later phase compares with: phase 5's 512^3 u (on the host)
KEPT = {}


def cycle_spec(mg, rtol, smoother="rbgs"):
    return mg.CycleSpec(nu1=2, nu2=2, smoother=smoother, restriction="pt",
                        tol=0.0, rtol=rtol, max_cycles=40, track_error=False)


def time_ms(torch, fn, reps=10, warmup=2):
    """Mean device time of fn() in ms, from CUDA events around reps calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(name, n, nc):
    """(bound_ms, bound_by) of kernel `name` on n fine and nc coarse f32
    points: the larger of its bytes over PEAK_BYTES_S and its operations
    over PEAK_F32_S."""
    fine, coarse = ARRAYS[name]
    t_bytes = 4.0 * (fine * n + coarse * nc) / PEAK_BYTES_S * 1e3
    ops = OPS[name] * n + OPS.get(name + "_c", 0) * nc
    t_ops = ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(f"phase 1 device: torch={name} count={torch.cuda.device_count()} "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(card)
    return name, card


def phase_build(build, out_dir):
    t0 = time.perf_counter()
    build.library()
    secs = time.perf_counter() - t0
    log = out_dir / "nvcc_build.log"
    if build.build_log is not None:
        log.write_text(build.build_log)
    print(f"phase 2 build: {secs:.2f} s ({build.library_path().name}; nvcc "
          f"output in {log})")
    return secs


def level_weights(mg, lm):
    """(wc, woff) of the const-7 operator on an lm^3 level, as
    build_lean_hierarchy scales the prototype's weights."""
    from multigrid_dolfinx_tpu_torch.fem.fast_const import build_const_template

    tmpl = build_const_template(mg.models.poisson3d().problem)
    scale = (1.0 / (lm - 1)) * tmpl.proto_n
    c = tmpl.offsets.index((0, 0, 0))
    return tmpl.weights[c] * scale, tmpl.weights[0] * scale


def phase_kernels(torch, np, mg, records):
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d as s3
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_norm as sn

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")

    def rand(lm):
        a = rng.standard_normal((lm,) * 3).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    err = {k: 0.0 for k in KERNELS_3D}
    kcuda.reset_launch_counts()
    for lm in KERNEL_LMS:
        wc, woff = level_weights(mg, lm)
        v, f = rand(lm), rand(lm)
        cases = [
            ("rb_sweep", s3.rb_sweep(v, f, lm, wc, woff),
             s3.rb_sweep_ref(v, f, lm, wc, woff), TOL_STENCIL),
            ("residual_tet_quad", sn.residual_tet_quad(v, f, lm, wc, woff, "right"),
             sn.residual_tet_quad_ref(v, f, lm, wc, woff, "right"), TOL_NORM),
        ]
        if lm > 9:
            lmc = (lm + 1) // 2
            c = rand(lmc)
            cases += [
                ("restrict_residual_pt",
                 s3.restrict_residual_pt(v, f, lm, lmc, wc, woff),
                 s3.restrict_residual_pt_ref(v, f, lm, lmc, wc, woff),
                 TOL_STENCIL),
                ("prolong_linear", s3.prolong_linear(c, lm),
                 s3.prolong_linear_ref(c, lm), TOL_STENCIL),
                ("prolong_linear_add", s3.prolong_linear(c, lm, v),
                 s3.prolong_linear_ref(c, lm, v), TOL_STENCIL),
            ]
        torch.cuda.synchronize()
        parts = []
        for name, out, ref, tol in cases:
            check_close(name, out, ref, tol, err, parts, f"lm={lm}")
        print(f"phase 3 lm={lm}: max|kernel-plain| " + " ".join(parts))
    counts = kcuda.launch_counts()
    missing = [k for k in KERNELS_3D if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"launch counters did not move: {missing}")

    # kernel vs plain times at the main path's shapes (finest 513^3 and
    # the 257^3 level below it), plain first, then kernel, then plain
    lm, lmc = TIMED_LM, (TIMED_LM + 1) // 2
    wc, woff = level_weights(mg, lm)
    v, f, c = rand(lm), rand(lm), rand(lmc)
    pairs = {
        "rb_sweep": (lambda: s3.rb_sweep(v, f, lm, wc, woff),
                     lambda: s3.rb_sweep_ref(v, f, lm, wc, woff)),
        "restrict_residual_pt": (
            lambda: s3.restrict_residual_pt(v, f, lm, lmc, wc, woff),
            lambda: s3.restrict_residual_pt_ref(v, f, lm, lmc, wc, woff)),
        "prolong_linear_add": (lambda: s3.prolong_linear(c, lm, v),
                               lambda: s3.prolong_linear_ref(c, lm, v)),
        "prolong_linear": (lambda: s3.prolong_linear(c, lm),
                           lambda: s3.prolong_linear_ref(c, lm)),
        "residual_tet_quad": (
            lambda: sn.residual_tet_quad(v, f, lm, wc, woff, "right"),
            lambda: sn.residual_tet_quad_ref(v, f, lm, wc, woff, "right")),
    }
    F = torch.nn.functional
    n, nc = lm ** 3, lmc ** 3
    shape = {"rb_sweep": (n, 0), "restrict_residual_pt": (n, nc),
             "prolong_linear_add": (n, nc), "prolong_linear": (n, nc),
             "residual_tet_quad": (n, 0)}
    library = {"prolong_linear": lambda: F.interpolate(
        c[None, None], size=(lm,) * 3, mode="trilinear", align_corners=True)}
    time_pairs(torch, pairs, err, records, f"phase 3 time at lm={lm}", shape,
               library)
    del v, f, c
    torch.cuda.empty_cache()


def time_pairs(torch, pairs, err, records, label, shape, library=None,
               bounds=None):
    """Kernel and plain times, run as plain, kernel, kernel, plain, and
    the library call's time where there is one; shape[name] = (fine
    points, coarse points) of the timed call, for its bound, unless
    bounds[name] gives (bound_ms, bound_by)."""
    library = library or {}
    bounds = bounds or {}
    for name, (kern, plain) in pairs.items():
        p1 = time_ms(torch, plain, reps=3, warmup=1)
        k1 = time_ms(torch, kern)
        k2 = time_ms(torch, kern)
        p2 = time_ms(torch, plain, reps=3, warmup=1)
        lib = library.get(name)
        lib_ms = min(time_ms(torch, lib), time_ms(torch, lib)) if lib else None
        bound_ms, bound_by = bounds.get(name) or bound(name, *shape[name])
        records[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": 0,
            "max_abs_err": err[name], "ms": min(k1, k2),
            "plain_ms": min(p1, p2), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
        }
        extra = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        print(f"{label} {name}: kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms{extra}, bound {bound_ms:.4f} ms "
              f"({bound_by})")


def no_tf32(torch, fn):
    """fn run with cuDNN's TF32 off: a yardstick in full f32."""
    def run():
        keep = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn()
        finally:
            torch.backends.cudnn.allow_tf32 = keep
    return run


def check_close(name, out, ref, tol, err, parts, where):
    """max|kernel - plain| within tol of max|plain|, recorded in err."""
    diff = float((out.double() - ref.double()).abs().max())
    scale = float(ref.double().abs().max())
    err[name] = max(err.get(name, 0.0), diff)
    parts.append(f"{name}={diff:.3e}")
    if not diff <= tol * scale:
        raise AssertionError(
            f"{name} at {where}: max|kernel-plain|={diff:.3e} > "
            f"{tol} * max|plain| = {tol * scale:.3e}")


def phase_small_slice(torch, np, mg):
    cyc = cycle_spec(mg, 1e-7)
    cfg = mg.models.poisson3d(finest_level=3, coarsest_level=0,
                              coarsest_elements=8, dtype="float32", cycle=cyc)
    torch.set_num_threads(8)
    res = {}
    for dev in ("cuda", "cpu"):
        hier = mg.build_lean_hierarchy(cfg, device=dev)
        res[dev] = mg.solve(hier, cyc)
    g, c = res["cuda"], res["cpu"]
    k = c.num_cycles
    hg = g.res_hist[:g.num_cycles].double().cpu().numpy()
    hc = c.res_hist[:k].double().numpy()
    du = float((g.u.cpu().double() - c.u.double()).abs().max())
    if g.num_cycles != k or not (g.converged and c.converged):
        raise AssertionError(f"64^3: card {g.num_cycles} cycles "
                             f"(converged {g.converged}), cpu {k} "
                             f"(converged {c.converged})")
    rel = np.abs(hg - hc) / np.abs(hc)
    print(f"phase 4 64^3 f32: {k} cycles on both; res_hist card {hg.tolist()} "
          f"cpu {hc.tolist()}; max rel diff {rel.max():.3e}; "
          f"max|u_card-u_cpu| {du:.3e}")
    if not np.all(rel <= 1e-4):
        raise AssertionError(f"64^3 res_hist differs: rel {rel.tolist()}")


def phase_main(torch, np, mg, card):
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda

    cyc = cycle_spec(mg, 1e-8)
    cfg = mg.models.poisson3d(finest_level=6, coarsest_level=0,
                              coarsest_elements=8, dtype="float32", cycle=cyc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kcuda.reset_launch_counts()
    t0 = time.perf_counter()
    hier = mg.build_lean_hierarchy(cfg, device=torch.device("cuda"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = mg.solve(hier, cyc)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kcuda.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lm = hier.finest.n + 1
    mid = lm // 2
    u_mid = float(res.u[mid, mid, mid])
    hist = res.res_hist[:res.num_cycles].double().cpu().numpy().tolist()
    KEPT["u_main"] = res.u.cpu()
    print(f"phase 5 512^3 f32: build {t1 - t0:.3f} s, solve {t2 - t1:.3f} s, "
          f"{res.num_cycles} cycles after FMG, converged={res.converged} "
          f"diverged={res.diverged}, res_hist {hist}, u(1/2,1/2,1/2)={u_mid!r}, "
          f"peak {peak_gb:.2f} GB, launches {counts}")
    if not res.converged or res.diverged:
        raise AssertionError("512^3 solve did not converge")
    if res.num_cycles > 3:
        raise AssertionError(f"512^3 took {res.num_cycles} cycles (> 3)")
    if not abs(u_mid - 2.5) < 1e-2:
        raise AssertionError(f"u(1/2,1/2,1/2) = {u_mid} is not 2.5 +- 1e-2")
    missing = [k for k in KERNELS_3D + KERNELS_TAIL
               if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main path did not launch {missing}")

    ms, rooted = time_vcycles(torch, mg, hier, cyc, res.u)
    dofs = lm ** 3
    print(f"phase 5 V-cycle: {ms:.4f} ms/V-cycle, {dofs / (ms * 1e-3):.4e} "
          f"DOF/s at {dofs} DOFs on [{card}]")
    print("phase 5 V-cycle rooted at lm (ms): " + ", ".join(
        f"{k}: {t:.4f}" for k, t in rooted.items()))
    return counts, {"build_s": t1 - t0, "solve_s": t2 - t1,
                    "cycles": res.num_cycles, "res_hist": hist,
                    "u_mid": u_mid, "ms_per_vcycle": ms,
                    "dof_per_s": dofs / (ms * 1e-3), "peak_gb": peak_gb,
                    "ms_per_vcycle_rooted_at_lm": rooted}


def time_vcycles(torch, mg, hier, cyc, u):
    """ms per V-cycle from u on the finest level (CUDA events over 10
    cycles), and the V-cycle rooted at each level from a zero guess:
    where the time goes."""
    L = hier.num_levels - 1
    holder = [u.clone()]

    def one_cycle():
        holder[0] = mg.vcycle(hier, cyc, L, holder[0], hier.finest.b)

    ms = time_ms(torch, one_cycle, reps=10, warmup=1)
    rooted = {}
    for li in range(1, L + 1):
        lv = hier.levels[li]
        held = [torch.zeros_like(lv.b)]

        def level_cycle():
            held[0] = mg.vcycle(hier, cyc, li, held[0], lv.b)

        rooted[lv.n + 1] = time_ms(torch, level_cycle, reps=10, warmup=2)
    return ms, rooted


def phase_kernels_2d(torch, np, records):
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil2d as s2

    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    w = 2.0 / 3.0
    err = {}
    kcuda.reset_launch_counts()
    for dtype in (torch.float32, torch.float64):
        for lm in KERNEL_LMS_2D:
            lmc = (lm + 1) // 2
            v, f, c = (torch.from_numpy(rng.standard_normal((n, n))).to(
                dev, dtype) for n in (lm, lm, lmc))
            cases = [
                ("jacobi_sweep_2d", s2.jacobi_sweep(v, f, lm, w),
                 s2.jacobi_sweep_ref(v, f, lm, w)),
                ("rb_sweep_2d", s2.rb_sweep(v, f, lm),
                 s2.rb_sweep_ref(v, f, lm)),
                ("residual_2d", s2.residual(v, f, lm),
                 s2.residual_ref(v, f, lm)),
                ("restrict_pt_2d", s2.restrict_pt(v, lm, lmc),
                 s2.restrict_pt_ref(v, lm, lmc)),
                ("prolong_linear_2d", s2.prolong_linear(c, lm),
                 s2.prolong_linear_ref(c, lm)),
            ]
            torch.cuda.synchronize()
            parts = []
            for name, out, ref in cases:
                check_close(name, out, ref, TOL_STENCIL, err, parts,
                            f"lm={lm} {dtype}")
            print(f"phase 6 lm={lm} {str(dtype)[6:]}: max|kernel-plain| "
                  + " ".join(parts))
            del v, f, c, cases
    counts = kcuda.launch_counts()
    missing = [k for k in s2.LAUNCHES if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"launch counters did not move: {missing}")

    lm = TIMED_LM_2D
    lmc = (lm + 1) // 2
    v, f, c = (torch.from_numpy(rng.standard_normal((n, n)).astype(
        np.float32)).to(dev) for n in (lm, lm, lmc))
    pairs = {
        "jacobi_sweep_2d": (lambda: s2.jacobi_sweep(v, f, lm, w),
                            lambda: s2.jacobi_sweep_ref(v, f, lm, w)),
        "rb_sweep_2d": (lambda: s2.rb_sweep(v, f, lm),
                        lambda: s2.rb_sweep_ref(v, f, lm)),
        "residual_2d": (lambda: s2.residual(v, f, lm),
                        lambda: s2.residual_ref(v, f, lm)),
        "restrict_pt_2d": (lambda: s2.restrict_pt(v, lm, lmc),
                           lambda: s2.restrict_pt_ref(v, lm, lmc)),
        "prolong_linear_2d": (lambda: s2.prolong_linear(c, lm),
                              lambda: s2.prolong_linear_ref(c, lm)),
    }
    F = torch.nn.functional
    n, nc = lm ** 2, lmc ** 2
    shape = {k: (n, nc) for k in pairs}
    w121 = torch.tensor([1.0, 2.0, 1.0], device=dev)
    kern_pt = (0.25 * torch.outer(w121, w121))[None, None]
    library = {
        "restrict_pt_2d": no_tf32(torch, lambda: F.conv2d(
            v[None, None], kern_pt, stride=2, padding=1)),
        "prolong_linear_2d": lambda: F.interpolate(
            c[None, None], size=(lm, lm), mode="bilinear",
            align_corners=True),
    }
    time_pairs(torch, pairs, err, records, f"phase 6 time at lm={lm} f32",
               shape, library)
    del v, f, c
    torch.cuda.empty_cache()


def count_of(res):
    """Cycles of a SolveResult, iterations of an MG-CG CGResult."""
    return res.num_iters if hasattr(res, "num_iters") else res.num_cycles


def compare_histories(np, name, card, cpu, rtol, atol):
    """Same cycle or iteration count and histories within rtol / atol,
    card vs CPU."""
    k = count_of(cpu)
    if count_of(card) != k or not (card.converged and cpu.converged):
        raise AssertionError(f"{name}: card {count_of(card)} cycles "
                             f"(converged {card.converged}), cpu {k} "
                             f"(converged {cpu.converged})")
    out = {}
    for h in ("res_hist", "err_hist"):
        if not hasattr(cpu, h):
            continue
        hg = getattr(card, h)[:k].double().cpu().numpy()
        hc = getattr(cpu, h)[:k].double().numpy()
        if np.isnan(hc).all():
            continue
        if not np.allclose(hg, hc, rtol=rtol, atol=atol):
            raise AssertionError(f"{name} {h} differs: card {hg.tolist()} "
                                 f"cpu {hc.tolist()}")
        out[h] = float((np.abs(hg - hc) / np.abs(hc)).max())
    return out


def phase_reference(torch, np, mg):
    """The reference's exact run in f64: 63 cycles on the card, as on the
    CPU, with res_hist and err_hist to rtol 1e-9 / atol 1e-13 (the f64
    coarse solve and the norms' sums round in another order on the
    card)."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda

    cfg = mg.models.poisson2d()
    cpu = mg.solve(mg.build_hierarchy(cfg, device="cpu"), cfg.cycle)
    torch.cuda.synchronize()
    kcuda.reset_launch_counts()
    t0 = time.perf_counter()
    hier = mg.build_hierarchy(cfg, device=torch.device("cuda"))
    res = mg.solve(hier, cfg.cycle)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kcuda.launch_counts()
    k = res.num_cycles
    rel = compare_histories(np, "reference run", res, cpu, 1e-9, 1e-13)
    final = (float(res.res_hist[k - 1]), float(res.err_hist[k - 1]))
    print(f"phase 7 reference run (65^2 f64, V(50,50) Jacobi, injection): "
          f"{k} cycles on the card, {cpu.num_cycles} on the cpu; build + "
          f"solve {secs:.3f} s; final residual {final[0]!r}, error "
          f"{final[1]!r}; max rel diff card/cpu {rel}; launches {counts}")
    if k != 63:
        raise AssertionError(f"the reference run took {k} cycles, not 63")
    missing = [n for n in KERNELS_REFERENCE if counts.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"reference run did not launch {missing}")
    return counts, {"cycles": k, "seconds": secs, "final_residual": final[0],
                    "final_error": final[1], "max_rel_diff_cpu": rel}


def phase_2d_small(torch, np, mg):
    """2049^2 f32 on the card against the plain path on the CPU."""
    cyc = cycle_spec(mg, RTOL_2D)
    cfg = mg.models.poisson2d(finest_level=8, coarsest_level=0,
                              coarsest_elements=8, dtype="float32", cycle=cyc)
    g, c = (mg.solve(mg.build_lean_hierarchy(cfg, device=dev), cyc)
            for dev in ("cuda", "cpu"))
    rel = compare_histories(np, "2049^2", g, c, 1e-4, 0.0)
    du = float((g.u.cpu().double() - c.u.double()).abs().max())
    print(f"phase 8 2049^2 f32: {c.num_cycles} cycles on both; res_hist card "
          f"{g.res_hist[:g.num_cycles].tolist()} cpu "
          f"{c.res_hist[:c.num_cycles].tolist()}; max rel diff {rel}; "
          f"max|u_card-u_cpu| {du:.3e}")


def solve_2d(torch, mg, dtype, rtol):
    """Build and solve the 2D production configuration at 8193^2 on the
    card, with the launch counts and the peak memory of that run."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda

    cyc = cycle_spec(mg, rtol)
    cfg = mg.models.poisson2d(finest_level=FINEST_LEVEL_2D, coarsest_level=0,
                              coarsest_elements=8, dtype=dtype, cycle=cyc)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kcuda.reset_launch_counts()
    t0 = time.perf_counter()
    hier = mg.build_lean_hierarchy(cfg, device=torch.device("cuda"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = mg.solve(hier, cyc)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kcuda.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res.res_hist[:res.num_cycles].double().cpu().numpy().tolist()
    mid = hier.finest.n // 2
    run = {"build_s": t1 - t0, "solve_s": t2 - t1, "cycles": res.num_cycles,
           "res_hist": hist, "u_mid": float(res.u[mid, mid]),
           "peak_gb": peak_gb}
    print(f"phase 9 8193^2 {dtype} ({hier.num_levels} levels, rtol {rtol}): "
          f"build {run['build_s']:.3f} s, solve {run['solve_s']:.3f} s, "
          f"{res.num_cycles} cycles after FMG, converged={res.converged} "
          f"diverged={res.diverged}, res_hist {hist}, "
          f"u(1/2,1/2)={run['u_mid']!r}, peak {peak_gb:.2f} GB, "
          f"launches {counts}")
    if not res.converged or res.diverged:
        raise AssertionError(f"8193^2 {dtype} solve did not converge")
    if res.num_cycles > 3:
        raise AssertionError(f"8193^2 {dtype} took {res.num_cycles} cycles "
                             "(> 3)")
    lm = 8 * 2 ** FINEST_LEVEL_2D + 1
    if tuple(res.u.shape) != (lm, lm) or not bool(
            torch.isfinite(res.u).all()):
        raise AssertionError(f"8193^2 {dtype} solution is not finite or has "
                             f"shape {tuple(res.u.shape)}")
    return hier, res, cyc, counts, run


def phase_main_2d(torch, np, mg, card):
    """The 2D production configuration at full width, 8193^2: the f32 run
    (the main path: launches, times, the f32 residual floor), then the
    same configuration in f64, which holds u(1/2,1/2) within 1e-2 of
    u* = 1.75.  The f32 run cannot: at this width the load 6 h^2 ~ 9e-8
    per node is below half an f32 ulp of the neighbour sum ~7, so the f32
    smoother's fixed point drifts from the discrete solution while the
    f32 residual check stays at its floor (PERF.md, Findings)."""
    from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm

    hier, res, cyc, counts, run = solve_2d(torch, mg, "float32", RTOL_2D)
    missing = [k for k in KERNELS_2D if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"2D main path did not launch {missing}")
    rn_ref = float(check_norm(hier, torch.zeros_like(hier.finest.b),
                              hier.finest.b))
    ms, rooted = time_vcycles(torch, mg, hier, cyc, res.u)
    dofs = (hier.finest.n + 1) ** 2
    print(f"phase 9 V-cycle f32: {ms:.4f} ms/V-cycle, "
          f"{dofs / (ms * 1e-3):.4e} DOF/s at {dofs} DOFs on [{card}]")
    print("phase 9 V-cycle f32 rooted at lm (ms): " + ", ".join(
        f"{k}: {t:.4f}" for k, t in rooted.items()))
    check = time_ms(torch, lambda: check_norm(hier, res.u, hier.finest.b),
                    reps=5, warmup=1)
    # the f32 floor: 6 more cycles from the solution, relative to ||b||_M
    more = mg.resume_solve(hier, dataclasses.replace(
        cycle_spec(mg, 1e-12), max_cycles=6), res.u)
    floor = (more.res_hist[:more.num_cycles].double().cpu().numpy()
             / rn_ref).tolist()
    print(f"phase 9 f32: per-cycle check {check:.4f} ms; ||b||_M "
          f"{rn_ref!r}; relative residual of 6 more cycles {floor}")
    u32 = res.u
    KEPT["u_2d"] = res.u.cpu()
    del hier, res, more

    hier64, res64, cyc64, _, run64 = solve_2d(torch, mg, "float64", 1e-7)
    ms64, _ = time_vcycles(torch, mg, hier64, cyc64, res64.u)
    du = float((res64.u - u32.double()).abs().max())
    print(f"phase 9 f64: {ms64:.4f} ms/V-cycle; |u(1/2,1/2) - 1.75| f64 "
          f"{abs(run64['u_mid'] - 1.75):.3e}, f32 "
          f"{abs(run['u_mid'] - 1.75):.3e}; max|u_f32 - u_f64| {du:.3e}")
    if not abs(run64["u_mid"] - 1.75) <= 1e-2:
        raise AssertionError(f"f64 u(1/2,1/2) = {run64['u_mid']} is not "
                             "1.75 +- 1e-2")
    del hier64, res64, u32
    torch.cuda.empty_cache()
    return counts, {**run, "rn_ref": rn_ref, "rtol": RTOL_2D,
                    "ms_per_vcycle": ms, "dof_per_s": dofs / (ms * 1e-3),
                    "ms_per_vcycle_rooted_at_lm": rooted, "check_ms": check,
                    "floor_rel_residuals": floor,
                    "f64": {**run64, "ms_per_vcycle": ms64,
                            "max_abs_u_f32_minus_f64": du}}


def phase_kernels_slice3(torch, np, mg, records):
    """K10-K12 against their plain versions in f32 and f64, bitwise (the
    Pallas association copied, --fmad=false), including the aliased calls:
    residual(p, p), the JAX package's MG-CG A p, and cheby_step with vp = v
    for a phase's first step."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d as s3
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_cheby as sc

    rng = np.random.default_rng(SEED + 2)
    dev = torch.device("cuda")
    w, a, b = 2.0 / 3.0, 0.3, 0.7
    err = {}
    kcuda.reset_launch_counts()
    for dtype in (torch.float32, torch.float64):
        for lm in KERNEL_LMS:
            wc, woff = level_weights(mg, lm)
            v, vp, f = (torch.from_numpy(rng.standard_normal((lm,) * 3)).to(
                dev, dtype) for _ in range(3))
            cases = [
                ("residual", s3.residual(v, f, lm, wc, woff),
                 s3.residual_ref(v, f, lm, wc, woff)),
                ("residual", s3.residual(v, v, lm, wc, woff),
                 s3.residual_ref(v, v, lm, wc, woff)),
                ("jacobi_sweep", s3.jacobi_sweep(v, f, lm, wc, woff, w),
                 s3.jacobi_sweep_ref(v, f, lm, wc, woff, w)),
                ("cheby_step", sc.cheby_step(v, vp, f, lm, wc, woff, a, b),
                 sc.cheby_step_ref(v, vp, f, lm, wc, woff, a, b)),
                ("cheby_step", sc.cheby_step(v, v, f, lm, wc, woff, 0.0, b),
                 sc.cheby_step_ref(v, v, f, lm, wc, woff, 0.0, b)),
            ]
            torch.cuda.synchronize()
            parts = []
            for name, out, ref in cases:
                check_close(name, out, ref, 0.0, err, parts,
                            f"lm={lm} {dtype}")
            print(f"phase 10 lm={lm} {str(dtype)[6:]}: max|kernel-plain| "
                  + " ".join(parts))
            del v, vp, f, cases
    counts = kcuda.launch_counts()
    missing = [k for k in KERNELS_SLICE3 if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"launch counters did not move: {missing}")

    lm = TIMED_LM
    wc, woff = level_weights(mg, lm)
    v, vp, f = (torch.from_numpy(rng.standard_normal((lm,) * 3).astype(
        np.float32)).to(dev) for _ in range(3))
    out = torch.empty_like(v)
    pairs = {
        "residual": (lambda: s3.residual(v, f, lm, wc, woff),
                     lambda: s3.residual_ref(v, f, lm, wc, woff)),
        "jacobi_sweep": (
            lambda: s3.jacobi_sweep(v, f, lm, wc, woff, w, out),
            lambda: s3.jacobi_sweep_ref(v, f, lm, wc, woff, w)),
        "cheby_step": (
            lambda: sc.cheby_step(v, vp, f, lm, wc, woff, a, b),
            lambda: sc.cheby_step_ref(v, vp, f, lm, wc, woff, a, b)),
    }
    time_pairs(torch, pairs, err, records, f"phase 10 time at lm={lm} f32",
               {k: (lm ** 3, 0) for k in pairs})
    del v, vp, f, out
    torch.cuda.empty_cache()


def slice3_specs(mg, rtol_c=1e-8, rtol_g1=1e-6):
    """(C) V(2,2) Chebyshev (one degree-2 polynomial per phase), (G1) the
    MG-CG capstone's weak V(1,1) Jacobi cycle (scripts/bench_mgcg.py),
    (G2) V(2,2) red-black; all with P^T restriction."""
    c = mg.CycleSpec(nu1=2, nu2=2, smoother="chebyshev", restriction="pt",
                     tol=0.0, rtol=rtol_c, max_cycles=40, track_error=False)
    g1 = mg.CycleSpec(nu1=1, nu2=1, smoother="jacobi", restriction="pt",
                      tol=0.0, rtol=rtol_g1, max_cycles=60, track_error=False)
    return c, g1, cycle_spec(mg, 1e-8)


def phase_small_slice3(torch, np, mg):
    """(C) and (G1) at 64^3 f32 on the card against the plain path on the
    CPU, at rtols above the f32 floor there (~1.5e-8 of ||b||_M at 64^3,
    plain path on the CPU): C to 1e-7, G1 to 1e-6.  Equal counts;
    histories to rtol 1e-4 for C (the coarse solve and K4's f64 sum round
    in another order on the card, as in phase 4) and 1e-3 for G1 (its
    dots are torch.sum in f32, reduced in another order on each device)."""
    c_spec, g1_spec, _ = slice3_specs(mg, RTOL_64["C"], RTOL_64["G1"])
    cfg = mg.models.poisson3d(finest_level=3, coarsest_level=0,
                              coarsest_elements=8, dtype="float32",
                              cycle=c_spec)
    torch.set_num_threads(8)
    runs = {"C": (lambda h: mg.solve(h, c_spec), 1e-4),
            "G1": (lambda h: mg.solve_mgcg(h, g1_spec, fmg_start=False),
                   1e-3)}
    for name, (run, rtol) in runs.items():
        card, cpu = (run(mg.build_lean_hierarchy(cfg, device=dev))
                     for dev in ("cuda", "cpu"))
        rel = compare_histories(np, f"64^3 {name}", card, cpu, rtol, 0.0)
        du = float((card.u.cpu().double() - cpu.u.double()).abs().max())
        k = count_of(cpu)
        print(f"phase 11 64^3 f32 ({name}, rtol {RTOL_64[name]}): {k} on "
              f"both; res_hist card {card.res_hist[:k].tolist()} cpu "
              f"{cpu.res_hist[:k].tolist()}; max rel diff {rel}; "
              f"max|u_card-u_cpu| {du:.3e}")


def run_512(torch, mg, name, cyc, solve, dtype="float32"):
    """Build the 512^3 lean hierarchy and run `solve` on it, with the
    launch counts set to 0 just before and read just after.  The run must
    converge and put u(1/2,1/2,1/2) within 1e-2 of 2.5."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda

    cfg = mg.models.poisson3d(finest_level=6, coarsest_level=0,
                              coarsest_elements=8, dtype=dtype, cycle=cyc)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kcuda.reset_launch_counts()
    t0 = time.perf_counter()
    hier = mg.build_lean_hierarchy(cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = solve(hier, cyc)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kcuda.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    k = count_of(res)
    mid = (hier.finest.n + 1) // 2
    run = {"build_s": t1 - t0, "solve_s": t2 - t1, "count": k,
           "converged": res.converged, "diverged": res.diverged,
           "res_hist": res.res_hist[:k].double().cpu().numpy().tolist(),
           "u_mid": float(res.u[mid, mid, mid]),
           "error_l2": float(mg.error_norm(hier, res.u)),
           "peak_gb": peak_gb,
           "launches": {n: c for n, c in counts.items() if c}}
    unit = "iterations" if hasattr(res, "num_iters") else "cycles"
    print(f"phase 12 512^3 {dtype} {name}: build {run['build_s']:.3f} s, solve "
          f"{run['solve_s']:.3f} s, {k} {unit}, converged={res.converged} "
          f"diverged={res.diverged}, res_hist {run['res_hist']}, "
          f"u(1/2,1/2,1/2)={run['u_mid']!r}, FEM-L2 error "
          f"{run['error_l2']!r}, peak {peak_gb:.2f} GB, launches "
          f"{run['launches']}")
    if not res.converged or res.diverged:
        raise AssertionError(f"512^3 {name} did not converge")
    if not math.isfinite(run["u_mid"]) or not abs(run["u_mid"] - 2.5) < 1e-2:
        raise AssertionError(f"512^3 {name}: u(1/2,1/2,1/2) = "
                             f"{run['u_mid']} is not 2.5 +- 1e-2")
    return hier, res, counts, run


def ms_per_cg_iteration(torch, mg, hier, cyc, fmg_start):
    """ms per MG-CG iteration: CUDA events around a 1-iteration and an
    11-iteration solve (tol = rtol = 0), the difference over the extra
    iterations run (fewer if the f32 iteration breaks down first)."""
    times, iters = [], []
    for n in (1, 11):
        spec = dataclasses.replace(cyc, tol=0.0, rtol=0.0, max_cycles=n)
        holder = []
        times.append(time_ms(torch, lambda: holder.append(
            mg.mgcg_solve(hier, spec, fmg_start=fmg_start).num_iters),
            reps=1, warmup=1))
        iters.append(holder[-1])
    return (times[1] - times[0]) / max(iters[1] - iters[0], 1), iters


def phase_slice3(torch, np, mg, card):
    """BASELINE configurations 3 and 5 at 512^3 f32: (C) FMG + V(2,2)
    Chebyshev, (G1) zero-start MG-CG with V(1,1) Jacobi beside the plain
    loop from zero, (G2) FMG-start MG-CG with V(2,2) red-black."""
    c_spec, g1_spec, g2_spec = slice3_specs(mg)
    out, counts = {}, {}
    dofs = 513 ** 3

    hier, res, counts["C"], out["C"] = run_512(
        torch, mg, "(C) FMG + V(2,2) Chebyshev, rtol 1e-8", c_spec, mg.solve)
    ms, rooted = time_vcycles(torch, mg, hier, c_spec, res.u)
    out["C"].update(ms_per_vcycle=ms, ms_per_vcycle_rooted_at_lm=rooted)
    print(f"phase 12 (C): {ms:.4f} ms per Chebyshev V(2,2) cycle, "
          f"{dofs / (ms * 1e-3):.4e} DOF/s on [{card}]; rooted at lm (ms): "
          + ", ".join(f"{k}: {t:.4f}" for k, t in rooted.items()))
    del hier, res

    hier, res, counts["G1"], out["G1"] = run_512(
        torch, mg, "(G1) zero-start MG-CG, V(1,1) Jacobi, rtol 1e-6",
        g1_spec, lambda h, c: mg.solve_mgcg(h, c, fmg_start=False))
    ms_it, iters = ms_per_cg_iteration(torch, mg, hier, g1_spec, False)
    out["G1"].update(ms_per_iteration=ms_it, timed_iterations=iters)
    print(f"phase 12 (G1): {ms_it:.4f} ms per MG-CG iteration (CUDA events, "
          f"{iters} iterations)")
    del hier, res

    hier, res, counts["G1 plain"], out["G1 plain"] = run_512(
        torch, mg, "(G1) plain V(1,1) Jacobi loop from zero, rtol 1e-6",
        g1_spec, lambda h, c: mg.resume_solve(h, c, torch.zeros_like(
            h.finest.b)))
    ms, _ = time_vcycles(torch, mg, hier, g1_spec, res.u)
    out["G1 plain"].update(ms_per_vcycle=ms)
    print(f"phase 12 (G1) plain: {ms:.4f} ms per V(1,1) Jacobi cycle; MG-CG "
          f"{out['G1']['count']} iterations vs {out['G1 plain']['count']} "
          f"cycles")
    if out["G1"]["count"] > out["G1 plain"]["count"]:
        raise AssertionError("(G1) MG-CG took more iterations than the "
                             "plain loop took cycles")
    del hier, res

    # the same zero-start MG-CG in f64: f32 must stop as near u as f64
    _, _, _, out["G1 f64"] = run_512(
        torch, mg, "(G1) zero-start MG-CG, V(1,1) Jacobi, rtol 1e-6",
        g1_spec, lambda h, c: mg.solve_mgcg(h, c, fmg_start=False),
        dtype="float64")
    print(f"phase 12 (G1) f32 vs f64: {out['G1']['count']} vs "
          f"{out['G1 f64']['count']} iterations, u(1/2,1/2,1/2) "
          f"{out['G1']['u_mid']!r} vs {out['G1 f64']['u_mid']!r}")

    _, _, counts["G1 FMG"], out["G1 FMG"] = run_512(
        torch, mg, "(G1) FMG + MG-CG, V(1,1) Jacobi, rtol 1e-6", g1_spec,
        mg.solve_mgcg)

    hier, res, counts["G2"], out["G2"] = run_512(
        torch, mg, "(G2) FMG + MG-CG, V(2,2) red-black, rtol 1e-8", g2_spec,
        mg.solve_mgcg)
    ms_it, iters = ms_per_cg_iteration(torch, mg, hier, g2_spec, False)
    out["G2"].update(ms_per_iteration=ms_it, timed_iterations=iters)
    print(f"phase 12 (G2): {ms_it:.4f} ms per MG-CG iteration (CUDA events, "
          f"{iters} iterations from zero)")
    del hier, res
    torch.cuda.empty_cache()

    path = {"residual": "G1", "jacobi_sweep": "G1", "cheby_step": "C",
            "tail_down": "G2", "tail_up": "G2"}
    for k, run in path.items():
        if counts[run].get(k, 0) == 0:
            raise AssertionError(f"512^3 ({run}) did not launch {k}")
    return {k: counts[run][k] for k, run in path.items()
            if k in KERNELS_SLICE3}, out


def tail_bound(lms, nu, leg):
    """(bound_ms, bound_by) of one tail leg over the levels lms (coarsest
    first): the down leg reads f_top and writes v and the restricted f
    of each level; the up leg reads v0 and each level's v and f and
    writes each level's result.  Operations as OPS: nu K1 sweeps per
    level, K2 on the way down, K3 with the add on the way up."""
    n = [lm ** 3 for lm in lms]
    if leg == "down":
        arrays = n[-1] + sum(n[1:]) + sum(n[:-1])
        ops = sum(nu * OPS["rb_sweep"] * n[l] + OPS["restrict_residual_pt"]
                  * n[l] + OPS["restrict_residual_pt_c"] * n[l - 1]
                  for l in range(1, len(n)))
    else:
        arrays = n[0] + 3 * sum(n[1:])
        ops = sum((nu * OPS["rb_sweep"] + OPS["prolong_linear_add"]) * n[l]
                  for l in range(1, len(n)))
    t_bytes = 4.0 * arrays / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_tail(torch, np, mg, records):
    """K13 tail_down and K14 tail_up against their plain versions (the
    per-level plain K1-K3 sequence) on the tails of the 512^3 hierarchy,
    in f32 and f64, nu = 2 and 1, bitwise; both legs get the same inputs
    (the up leg the plain down leg's outputs and a random coarse
    solution).  Then kernel / plain times on the 65^3-topped tail (f32, nu
    = 2), and the V-cycle rooted at 65^3 and 129^3 with the tail and with
    the per-level path (TAIL_MAX_LM = 0), in one run."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_tail as st
    from multigrid_dolfinx_tpu_torch.solver import vcycle as vc

    rng = np.random.default_rng(SEED + 3)
    dev = torch.device("cuda")
    err = {}
    kcuda.reset_launch_counts()
    for dtype in (torch.float32, torch.float64):
        for lms in TAIL_CHAINS:
            weights = tuple(level_weights(mg, lm) for lm in lms)
            for nu in (2, 1):
                f, v0 = (torch.from_numpy(rng.standard_normal((n,) * 3)).to(
                    dev, dtype) for n in (lms[-1], lms[0]))
                vs, fs = st.tail_down(f, lms, weights, nu)
                rvs, rfs = st.tail_down_ref(f, lms, weights, nu)
                up = st.tail_up(v0, f, rvs, rfs[:-1], lms, weights, nu)
                rup = st.tail_up_ref(v0, f, rvs, rfs[:-1], lms, weights, nu)
                torch.cuda.synchronize()
                parts, where = [], f"levels {lms} nu={nu} {dtype}"
                for out, ref in zip(vs + fs, rvs + rfs):
                    check_close("tail_down", out, ref, 0.0, err, parts, where)
                check_close("tail_up", up, rup, 0.0, err, parts, where)
                print(f"phase 13 levels {lms} nu={nu} {str(dtype)[6:]}: "
                      "max|kernel-plain| " + " ".join(parts))
    counts = kcuda.launch_counts()
    missing = [k for k in KERNELS_TAIL if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"launch counters did not move: {missing}")

    lms = TAIL_CHAINS[-1]
    weights = tuple(level_weights(mg, lm) for lm in lms)
    f, v0 = (torch.from_numpy(rng.standard_normal((n,) * 3).astype(
        np.float32)).to(dev) for n in (lms[-1], lms[0]))
    vs, fs = st.tail_down_ref(f, lms, weights, 2)
    pairs = {
        "tail_down": (lambda: st.tail_down(f, lms, weights, 2),
                      lambda: st.tail_down_ref(f, lms, weights, 2)),
        "tail_up": (
            lambda: st.tail_up(v0, f, vs, fs[:-1], lms, weights, 2),
            lambda: st.tail_up_ref(v0, f, vs, fs[:-1], lms, weights, 2)),
    }
    for name, (kern, plain) in pairs.items():
        p1 = time_ms(torch, plain, reps=3, warmup=1)
        k1, k2 = time_ms(torch, kern), time_ms(torch, kern)
        p2 = time_ms(torch, plain, reps=3, warmup=1)
        bound_ms, bound_by = tail_bound(lms, 2, name[5:])
        records[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": 0,
            "max_abs_err": err[name], "ms": min(k1, k2),
            "plain_ms": min(p1, p2), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        }
        print(f"phase 13 time on levels {lms} f32 {name}: kernel "
              f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by})")

    # the V-cycle rooted at the tail's tops, with the tail and without
    cyc = cycle_spec(mg, 1e-8)
    cfg = mg.models.poisson3d(finest_level=4, coarsest_level=0,
                              coarsest_elements=8, dtype="float32", cycle=cyc)
    hier = mg.build_lean_hierarchy(cfg)
    rooted = {}
    keep = vc.TAIL_MAX_LM
    try:
        for mode, top in (("tail", keep), ("per-level", 0), ("tail", keep),
                          ("per-level", 0)):
            vc.TAIL_MAX_LM = top
            for li in (3, 4):
                lv = hier.levels[li]
                held = [torch.zeros_like(lv.b)]

                def level_cycle():
                    held[0] = mg.vcycle(hier, cyc, li, held[0], lv.b)

                key = f"{mode} {lv.n + 1}"
                ms = time_ms(torch, level_cycle, reps=20, warmup=3)
                rooted[key] = min(rooted.get(key, ms), ms)
    finally:
        vc.TAIL_MAX_LM = keep
    print("phase 13 V-cycle rooted at lm, f32 (ms): " + ", ".join(
        f"{k}: {t:.4f}" for k, t in rooted.items()))
    del hier
    torch.cuda.empty_cache()
    return {"ms_per_vcycle_rooted": rooted,
            "max_abs_err": {k: err[k] for k in KERNELS_TAIL}}


def var_kappa(x, y, z):
    """kappa = 1 + x + 2y + z, scripts/bench_var_scale.py's coefficient."""
    return 1.0 + x + 2.0 * y + z


def planes_sets(mg):
    from multigrid_dolfinx_tpu_torch.fem.fast_var import structural_offsets

    return {"kuhn15": structural_offsets(3, "right"), "box27": BOX27,
            "axis7": AXIS7, "radius2": RADIUS2}


def random_planes(torch, gen, offs, lm, dtype):
    """Random planes on the card with a dominant centre plane (one GS
    sweep stays bounded), and random v and f."""
    dev = torch.device("cuda")
    planes = torch.randn((len(offs),) + (lm,) * 3, generator=gen,
                         device=dev, dtype=dtype)
    c = offs.index((0, 0, 0))
    planes[c].abs_().add_(float(len(offs)))
    v, f = (torch.randn((lm,) * 3, generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    return planes, v, f


def phase_planes_kernels(torch, np, mg, records):
    """K15-K18 against their plain versions on the card, bitwise, then
    kernel / plain / library times at 385^3 f32 and the card-built
    Galerkin planes against the CPU's f64 build."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d as s3
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_planes as sp

    sets = planes_sets(mg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    w = 2.0 / 3.0
    err = {}
    kcuda.reset_launch_counts()
    for dtype in (torch.float32, torch.float64):
        for lm in PLANES_LMS:
            parts = []
            for name, offs in sets.items():
                planes, v, f = random_planes(torch, gen, offs, lm, dtype)
                cases = [
                    ("planes3_residual", sp.planes3_residual(v, f, planes, offs),
                     sp.planes3_residual_ref(v, f, planes, offs)),
                    ("planes3_jacobi_sweep",
                     sp.planes3_jacobi_sweep(v, f, planes, offs, w),
                     sp.planes3_jacobi_sweep_ref(v, f, planes, offs, w)),
                    ("planes3_gs_sweep",
                     sp.planes3_gs_sweep(v.clone(), f, planes, offs),
                     sp.planes3_gs_sweep_ref(v.clone(), f, planes, offs)),
                ]
                torch.cuda.synchronize()
                for kname, out, ref in cases:
                    check_close(kname, out, ref, 0.0, err, parts,
                                f"lm={lm} {name} {dtype}")
                    if not bool(torch.isfinite(out).all()):
                        raise AssertionError(f"{kname} at lm={lm} {name}: "
                                             "non-finite output")
                parts[-3:] = [f"{name}:" + ",".join(
                    q.split("=")[1] for q in parts[-3:])]
                del planes, v, f, cases
            lmc = (lm + 1) // 2
            r = torch.randn((lm,) * 3, generator=gen, device="cuda",
                            dtype=dtype)
            check_close("restrict_pt", s3.restrict_pt(r, lm, lmc),
                        s3.restrict_pt_ref(r, lm, lmc), 0.0, err, parts,
                        f"lm={lm} {dtype}")
            del r
            print(f"phase 14 lm={lm} {str(dtype)[6:]}: max|kernel-plain| "
                  "(residual,jacobi,gs) " + " ".join(parts))
            torch.cuda.empty_cache()
    counts = kcuda.launch_counts()
    missing = [k for k in KERNELS_PLANES if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"launch counters did not move: {missing}")

    lm, lmc = TIMED_LM_VAR, (TIMED_LM_VAR + 1) // 2
    offs = sets["kuhn15"]
    planes, v, f = random_planes(torch, gen, offs, lm, torch.float32)
    out = torch.empty_like(v)
    vg, vr = v.clone(), v.clone()       # K17 and its plain version in place
    pairs = {
        "planes3_residual": (
            lambda: sp.planes3_residual(v, f, planes, offs),
            lambda: sp.planes3_residual_ref(v, f, planes, offs)),
        "planes3_jacobi_sweep": (
            lambda: sp.planes3_jacobi_sweep(v, f, planes, offs, w, out),
            lambda: sp.planes3_jacobi_sweep_ref(v, f, planes, offs, w)),
        "planes3_gs_sweep": (
            lambda: sp.planes3_gs_sweep(vg, f, planes, offs),
            lambda: sp.planes3_gs_sweep_ref(vr, f, planes, offs)),
        "restrict_pt": (lambda: s3.restrict_pt(v, lm, lmc),
                        lambda: s3.restrict_pt_ref(v, lm, lmc)),
    }
    F = torch.nn.functional
    w121 = torch.tensor([1.0, 2.0, 1.0], device="cuda")
    kern_pt = (0.125 * w121[:, None, None] * w121[None, :, None]
               * w121[None, None, :])[None, None]
    library = {"restrict_pt": no_tf32(torch, lambda: F.conv3d(
        v[None, None], kern_pt, stride=2, padding=1))}
    shape = {k: (lm ** 3, lmc ** 3 if k == "restrict_pt" else 0)
             for k in pairs}
    time_pairs(torch, pairs, err, records, f"phase 14 time at lm={lm} f32",
               shape, library)
    del planes, v, f, out, vg, vr
    torch.cuda.empty_cache()
    return {"max_abs_err": {k: err[k] for k in KERNELS_PLANES},
            "galerkin_planes": galerkin_tf32_check(torch, np, mg)}


def galerkin_tf32_check(torch, np, mg):
    """The Galerkin planes of a 129^3 variable-kappa hierarchy (5 levels)
    against the CPU's f64 build, as max|card - cpu| over max|cpu| per
    level.  Each RAP step on the card in f32, fed the CPU's f64 planes of
    the level above rounded to f32, within 1e-6 (a TF32 convolution misses
    by ~1e-3); the hierarchy built on the card in f32 throughout within
    1e-6 per RAP step below the finest (f32 rounding adds up over the
    steps: 4e-6 at 9^3)."""
    from multigrid_dolfinx_tpu_torch.fem import fast_var

    cyc = cycle_spec(mg, 1e-6)
    hs = {}
    for dev, dtype in (("cuda", "float32"), ("cpu", "float64")):
        cfg = mg.models.variable_coefficient_3d(
            var_kappa, finest_level=4, coarsest_level=0, coarsest_elements=8,
            dtype=dtype, cycle=cyc)
        hs[dev] = mg.build_var_hierarchy(cfg, device=dev)
    cpu = hs["cpu"].levels
    step, built, limit = {}, {}, {}
    for l, lc in enumerate(cpu):
        limit[lc.n + 1] = 1e-6 * max(1, len(cpu) - 1 - l)
        ref = lc.A.planes
        scale = ref.abs().max()
        built[lc.n + 1] = float((hs["cuda"].levels[l].A.planes.cpu().double()
                                 - ref).abs().max() / scale)
        if l + 1 < len(cpu):
            fine = cpu[l + 1]
            offs, rap = fast_var.galerkin_rap_device(
                fine.A.offsets, fine.A.planes.float().cuda(), fine.n + 1)
            rap = fast_var.eliminate_dirichlet_device(offs, rap, lc.n + 1)
            step[lc.n + 1] = float((rap.cpu().double() - ref).abs().max()
                                   / scale)
    print("phase 14 Galerkin planes vs the cpu's f64, max rel diff by lm: "
          "one f32 RAP step on the card " + ", ".join(
              f"{k}: {e:.3e}" for k, e in step.items())
          + "; the card's f32 build " + ", ".join(
              f"{k}: {e:.3e}" for k, e in built.items()))
    bad = ({k: e for k, e in step.items() if not e <= 1e-6},
           {k: e for k, e in built.items() if not e <= limit[k]})
    if bad[0] or bad[1]:
        raise AssertionError(f"card-built Galerkin planes differ: {bad}")
    return {"rap_step_f32": step, "build_f32": built}


def var_state(hier):
    """A port hierarchy's state as numpy (utils.convert's format)."""
    return {
        "levels": [{"b": lv.b.cpu().numpy(), "g": lv.g.cpu().numpy(),
                    "n": lv.n, "offsets": lv.A.offsets,
                    "planes": lv.A.planes.cpu().numpy(), "lmax": lv.sm.lmax}
                   for lv in hier.levels],
        "coarse": {"factor": hier.coarse.factor.cpu().numpy(), "piv": None,
                   "kind": hier.coarse.kind},
        "class_tables": hier.M_fine.class_tables.cpu().numpy(),
        "uniform_p1_mass": hier.M_fine.uniform_p1_mass,
    }


def phase_small_var(torch, np, mg):
    """The variable-kappa slice at 64^3 f32, Galerkin, V(2,2), rbgs and
    jacobi, rtol 1e-6: the CPU-built hierarchy carried to the card solves
    bitwise as on the CPU (the kernels are bitwise their plain versions,
    the coarse factor is f64 and the norm's sum is taken in f64); the
    card-built hierarchy takes the same number of cycles."""
    torch.set_num_threads(8)
    out = {}
    for smoother in ("rbgs", "jacobi"):
        cyc = mg.CycleSpec(nu1=2, nu2=2, smoother=smoother, restriction="pt",
                           tol=0.0, rtol=1e-6, max_cycles=60,
                           track_error=False)
        cfg = mg.models.variable_coefficient_3d(
            var_kappa, finest_level=3, coarsest_level=0, coarsest_elements=8,
            dtype="float32", cycle=cyc)
        h_cpu = mg.build_var_hierarchy(cfg, device="cpu")
        cpu = mg.solve(h_cpu, cyc)
        carried = mg.solve(mg.hierarchy_from_numpy(var_state(h_cpu), cfg),
                           cyc)
        built = mg.solve(mg.build_var_hierarchy(cfg), cyc)
        k = cpu.num_cycles
        hc = cpu.res_hist[:k].numpy()
        hg = carried.res_hist[:carried.num_cycles].cpu().numpy()
        hb = built.res_hist[:built.num_cycles].cpu().numpy()
        print(f"phase 15 64^3 f32 var kappa {smoother}: cpu {k} cycles "
              f"{hc.tolist()}; carried to the card {carried.num_cycles} "
              f"{hg.tolist()}; card-built {built.num_cycles} {hb.tolist()}")
        if not (cpu.converged and carried.converged and built.converged):
            raise AssertionError(f"64^3 var {smoother} did not converge")
        if carried.num_cycles != k or not np.array_equal(hg, hc):
            raise AssertionError(f"64^3 var {smoother}: card res_hist is not "
                                 "bitwise the CPU's")
        if not torch.equal(carried.u.cpu(), cpu.u):
            raise AssertionError(f"64^3 var {smoother}: u differs")
        if built.num_cycles != k:
            raise AssertionError(f"64^3 var {smoother}: card-built took "
                                 f"{built.num_cycles} cycles, cpu {k}")
        out[smoother] = {"cycles": k, "res_hist": hc.tolist(),
                         "card_built_res_hist": hb.tolist()}
    return out


def var_config(mg, dtype, smoother="rbgs"):
    """scripts/bench_var_scale.py's configuration at 384^3."""
    from multigrid_dolfinx_tpu_torch.mesh import factor_levels

    base, finest = factor_levels(384)
    cyc = mg.CycleSpec(nu1=2, nu2=2, smoother=smoother, restriction="pt",
                       tol=0.0, rtol=1e-6, max_cycles=40, track_error=False)
    return mg.models.variable_coefficient_3d(
        var_kappa, finest_level=finest, coarsest_level=max(0, finest - 4),
        coarsest_elements=base, dtype=dtype, cycle=cyc), cyc


def run_var(torch, mg, dtype, label, hier=None, smoother="rbgs"):
    """Build (unless given) and solve the 384^3 configuration, the launch
    counts set to 0 just before and read just after; the coarse factor's
    seconds measured inside the build."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
    from multigrid_dolfinx_tpu_torch.solver import hierarchy as hmod

    cfg, cyc = var_config(mg, dtype, smoother)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kcuda.reset_launch_counts()
    factor_s = [0.0]
    build_coarse = hmod.build_coarse_solver

    def timed_coarse(*a, **kw):
        t = time.perf_counter()
        c = build_coarse(*a, **kw)
        factor_s[0] += time.perf_counter() - t
        return c

    t0 = time.perf_counter()
    if hier is None:
        hmod.build_coarse_solver = timed_coarse
        try:
            hier = mg.build_var_hierarchy(cfg)
        finally:
            hmod.build_coarse_solver = build_coarse
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = mg.solve(hier, cyc)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kcuda.launch_counts()
    mid = hier.finest.n // 2
    run = {"build_s": t1 - t0, "coarse_factor_s": factor_s[0],
           "solve_s": t2 - t1, "cycles": res.num_cycles,
           "converged": res.converged,
           "res_hist": res.res_hist[:res.num_cycles].double().cpu()
           .numpy().tolist(),
           "u_mid": float(res.u[mid, mid, mid]),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "levels": [lv.n + 1 for lv in hier.levels],
           "launches": {n: c for n, c in counts.items() if c}}
    print(f"phase 16 384^3 {dtype} {label}: levels {run['levels']}, build "
          f"{run['build_s']:.3f} s (coarse factor {run['coarse_factor_s']:.3f}"
          f" s), solve {run['solve_s']:.3f} s, {res.num_cycles} cycles after "
          f"FMG, converged={res.converged} diverged={res.diverged}, res_hist "
          f"{run['res_hist']}, u(1/2,1/2,1/2)={run['u_mid']!r}, peak "
          f"{run['peak_gb']:.2f} GB, launches {run['launches']}")
    if not res.converged or res.diverged or not math.isfinite(run["u_mid"]):
        raise AssertionError(f"384^3 {dtype} {label} did not converge")
    return hier, res, counts, run


def check_levels(torch, hier, err, label):
    """The kernels of the var path at the shapes it gives them: on every
    level of `hier`, K15, K16 and K17 with the level's own planes and b
    and a random v, K18 of K15's residual to the level below and K3 from
    a random coarse field, each bitwise against its plain version."""
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d as s3
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_planes as sp

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for li, lv in enumerate(hier.levels):
        A, f, lm = lv.A, lv.b, lv.n + 1
        v = torch.randn(f.shape, generator=gen, device="cuda", dtype=f.dtype)
        r = sp.planes3_residual(v, f, A.planes, A.offsets)
        cases = [
            ("planes3_residual", r,
             sp.planes3_residual_ref(v, f, A.planes, A.offsets)),
            ("planes3_jacobi_sweep",
             sp.planes3_jacobi_sweep(v, f, A.planes, A.offsets, lv.sm.omega),
             sp.planes3_jacobi_sweep_ref(v, f, A.planes, A.offsets,
                                         lv.sm.omega)),
            ("planes3_gs_sweep",
             sp.planes3_gs_sweep(v.clone(), f, A.planes, A.offsets),
             sp.planes3_gs_sweep_ref(v.clone(), f, A.planes, A.offsets)),
        ]
        if li > 0:
            lmc = hier.levels[li - 1].n + 1
            c = torch.randn((lmc,) * 3, generator=gen, device="cuda",
                            dtype=f.dtype)
            cases += [
                ("restrict_pt", s3.restrict_pt(r, lm, lmc),
                 s3.restrict_pt_ref(r, lm, lmc)),
                ("prolong_linear", s3.prolong_linear(c, lm),
                 s3.prolong_linear_ref(c, lm)),
                ("prolong_linear_add", s3.prolong_linear(c, lm, v),
                 s3.prolong_linear_ref(c, lm, v)),
            ]
        torch.cuda.synchronize()
        parts = []
        for name, out, ref in cases:
            check_close(name, out, ref, 0.0, err, parts, f"{label} lm={lm}")
        print(f"phase 16 {label} level lm={lm} ({len(A.offsets)} planes): "
              "max|kernel-plain| " + " ".join(parts))
        del v, r, cases
        torch.cuda.empty_cache()


def more_cycles(mg, hier, cyc, u):
    """u(1/2,1/2,1/2) after 6 more V-cycles from u: where the iteration
    settles in the hierarchy's dtype."""
    more = mg.resume_solve(hier, dataclasses.replace(cyc, rtol=0.0,
                                                     max_cycles=6), u)
    mid = hier.finest.n // 2
    return float(more.u[mid, mid, mid])


def phase_var(torch, np, mg, card, records):
    """bench_var_scale.py's configuration at 384^3: f32 red-black (the
    slice's main path: launches, 10 timed V-cycles), the path's kernels on
    each level against their plain versions, a Jacobi solve on the same
    hierarchy (K16 at full size), the f64 witness on the f32 build's
    operator, then f64 for the discrete solution."""
    err = {}
    hier, res, counts, out = run_var(torch, mg, "float32", "V(2,2) rbgs")
    _, cyc = var_config(mg, "float32")
    ms, rooted = time_vcycles(torch, mg, hier, cyc, res.u)
    dofs = (hier.finest.n + 1) ** 3
    from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm

    check = time_ms(torch, lambda: check_norm(hier, res.u, hier.finest.b),
                    reps=3, warmup=1)
    out.update(ms_per_vcycle=ms, dof_per_s=dofs / (ms * 1e-3),
               ms_per_vcycle_rooted_at_lm=rooted, check_ms=check)
    print(f"phase 16 V-cycle f32: {ms:.4f} ms/V-cycle, "
          f"{dofs / (ms * 1e-3):.4e} DOF/s at {dofs} DOFs on [{card}]; "
          f"check {check:.4f} ms; rooted at lm (ms): " + ", ".join(
              f"{k}: {t:.4f}" for k, t in rooted.items()))
    missing = [k for k in ("planes3_residual", "planes3_gs_sweep",
                           "restrict_pt", "prolong_linear_add",
                           "prolong_linear") if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"384^3 var path did not launch {missing}")
    u32 = res.u
    out["u_mid_6_more_cycles"] = more_cycles(mg, hier, cyc, u32)
    del res
    check_levels(torch, hier, err, "f32")

    _, res_j, counts_j, out["jacobi"] = run_var(
        torch, mg, "float32", "V(2,2) jacobi", hier=hier, smoother="jacobi")
    if counts_j.get("planes3_jacobi_sweep", 0) == 0:
        raise AssertionError("384^3 jacobi run did not launch K16")
    del res_j

    # the witness: f64 arithmetic on the f32 build's planes, b and g (cast
    # up exactly) and its coarse factor; where its u lands says whether
    # the f32 operator or the f32 cycle moves u away from the f64 run's
    cfg64, cyc64 = var_config(mg, "float64")
    hw = mg.hierarchy_from_numpy(var_state(hier), cfg64)
    del hier
    res_w = mg.solve(hw, cyc64)
    mid = hw.finest.n // 2
    out["witness"] = {"cycles": res_w.num_cycles,
                      "converged": res_w.converged,
                      "u_mid": float(res_w.u[mid, mid, mid]),
                      "u_mid_6_more_cycles": more_cycles(mg, hw, cyc64,
                                                         res_w.u)}
    if not res_w.converged or not math.isfinite(out["witness"]["u_mid"]):
        raise AssertionError("384^3 f64 witness did not converge")
    du_w = float((res_w.u - u32.double()).abs().max())
    del hw, res_w
    torch.cuda.empty_cache()

    hier64, res64, _, out["f64"] = run_var(torch, mg, "float64",
                                           "V(2,2) rbgs")
    out["f64"]["u_mid_6_more_cycles"] = more_cycles(mg, hier64, cyc,
                                                    res64.u)
    check_levels(torch, hier64, err, "f64")
    du = float((res64.u - u32.double()).abs().max())
    d_mid = abs(out["u_mid"] - out["f64"]["u_mid"])
    w = out["witness"]
    out["max_abs_u_f32_minus_f64"] = du
    out["max_abs_u_f32_minus_witness"] = du_w
    print(f"phase 16 f32 vs f64: u(1/2,1/2,1/2) {out['u_mid']!r} vs "
          f"{out['f64']['u_mid']!r} (|diff| {d_mid:.3e}); max|u_f32 - u_f64| "
          f"{du:.3e}; after 6 more cycles {out['u_mid_6_more_cycles']!r} vs "
          f"{out['f64']['u_mid_6_more_cycles']!r}")
    print(f"phase 16 witness (f64 cycles on the f32 build's operator): "
          f"{w['cycles']} cycles, u(1/2,1/2,1/2) {w['u_mid']!r} (|diff| to "
          f"f32 {abs(w['u_mid'] - out['u_mid']):.3e}, to f64 "
          f"{abs(w['u_mid'] - out['f64']['u_mid']):.3e}); after 6 more "
          f"cycles {w['u_mid_6_more_cycles']!r}; max|u_f32 - u_witness| "
          f"{du_w:.3e}")
    # f32 u(1/2,1/2,1/2) misses the f64 run's by ~1.06e-3, and the witness
    # says why: ~1.01e-3 of it is the f32 build's operator, ~5e-5 the f32
    # cycle (NVIDIA H100, PERF.md).  Each share is held to its own limit.
    d_op = abs(w["u_mid"] - out["f64"]["u_mid"])
    if not (du_w <= 1e-4 and d_op <= 1.2e-3):
        raise AssertionError(
            f"f32 u vs the witness {du_w:.3e} (limit 1e-4), witness "
            f"u(1/2,1/2,1/2) vs f64 {d_op:.3e} (limit 1.2e-3)")
    del hier64, res64, u32
    torch.cuda.empty_cache()
    launches = {k: counts[k] for k in KERNELS_PLANES if k in counts}
    launches["planes3_jacobi_sweep"] = counts_j["planes3_jacobi_sweep"]
    for k, e in err.items():
        records[k]["max_abs_err"] = max(records[k]["max_abs_err"], e)
    out["levels_max_abs_err"] = err
    return launches, out


def p2_tables(torch, lm, dtype):
    """(stiffness offsets, tables, mass offsets, tables) of the P2 level
    on an lm^3 lattice, scaled as build_p2_hierarchy scales them."""
    import multigrid_dolfinx_tpu_torch as mg
    from multigrid_dolfinx_tpu_torch.fem import fast_p2

    t = fast_p2.build_p2_template(mg.models.poisson3d_p2().problem)
    h = 2.0 / (lm - 1)
    return (t.offsets, fast_p2.level_tables(t.a_unit, h, dtype, "cuda"),
            t.m_offsets, fast_p2.level_tables(t.m_unit, h ** 3, dtype,
                                              "cuda"))


def p2_ops_per_node(tables, lm, name):
    """f32 operations a node of kernel `name` does on an lm^3 lattice with
    these tables, counted from csrc/stencil3d_p2.cu (zero weights are
    skipped): K19 a multiply and an add per nonzero weight of the node's
    parity class and the subtraction, f - v on boundary rows; K20 the same
    without the centre, and 4 more (keep v, f - acc, the product, the
    sum), nothing on boundary rows; K21 on every node, with its true
    class, and the product r (M r) and its f64 sum."""
    nnz = (tables != 0).sum(0).cpu().tolist()          # (64,) per class
    inner = [i for i in range(1, lm - 1)]
    count = {0: 1, 1: sum(1 for i in inner if i % 2 == 0),
             2: sum(1 for i in inner if i % 2 == 1), 3: 1}
    total, n_int = 0.0, 0
    for cz in range(4):
        for cy in range(4):
            for cx in range(4):
                n = count[cz] * count[cy] * count[cx]
                k = nnz[(cz * 4 + cy) * 4 + cx]
                interior = all(c in (1, 2) for c in (cz, cy, cx))
                if name == "p2_mass_quad":
                    total += n * (2 * k + 2)
                elif interior:
                    n_int += n
                    total += n * (2 * k + 1 if name == "p2_residual"
                                  else 2 * (k - 1) + 4)
    if name == "p2_residual":
        total += lm ** 3 - n_int
    return total / lm ** 3


class PlainCalls:
    """Counts the calls of every plain kernel version (the `*_ref`
    functions of ops/cuda/*.py) while active: on the card a main path
    must make none."""

    def __enter__(self):
        from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda

        self.calls, self.saved = {}, []
        for mod in (kcuda.stencil2d, kcuda.stencil2d_planes,
                    kcuda.stencil3d, kcuda.stencil3d_cheby,
                    kcuda.stencil3d_norm, kcuda.stencil3d_p2,
                    kcuda.stencil3d_planes, kcuda.stencil3d_tail):
            for name in dir(mod):
                fn = getattr(mod, name)
                if name.endswith("_ref") and callable(fn):
                    self.saved.append((mod, name, fn))
                    setattr(mod, name, self._counted(name, fn))
        return self

    def _counted(self, name, fn):
        def run(*a, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a, **kw)
        return run

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def p2_conv_library(torch, v, tables, offsets):
    """One cuDNN conv3d (TF32 off) computing the P2 stencil sum of v at
    every node from its parity class's weights: 8 output channels (the
    classes), a 6^3 kernel holding each class's 51 weights shifted by its
    parity, stride 2; no masks and no boundary rows.  A yardstick for K19,
    never called by the port."""
    from multigrid_dolfinx_tpu_torch.ops.cuda.stencil3d_p2 import (
        INTERIOR_CLASSES)

    F = torch.nn.functional
    W = torch.zeros((8, 1, 6, 6, 6), dtype=v.dtype, device=v.device)
    for c, flat in enumerate(INTERIOR_CLASSES):
        pz, py, px = c >> 2, (c >> 1) & 1, c & 1
        for k, (dz, dy, dx) in enumerate(offsets):
            W[c, 0, dz + pz + 2, dy + py + 2, dx + px + 2] = tables[k, flat]
    vp = F.pad(v, (2, 3) * 3)[None, None]
    return no_tf32(torch, lambda: F.conv3d(vp, W, stride=2))


def phase_p2_kernels(torch, np, mg, records):
    """K19-K21 against their plain versions on the card, bitwise, in f32
    and f64 at P2_LMS with each lattice's own tables (so zero weights are
    skipped as on the main path), K21 also on r = f (nonzero face rows);
    then kernel / plain times at 513^3 f32."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_p2 as k2

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    w = 2.0 / 3.0
    err = {}
    kcuda.reset_launch_counts()
    for dtype in (torch.float32, torch.float64):
        for lm in P2_LMS:
            offs, a_t, m_offs, m_t = p2_tables(torch, lm, dtype)
            v, f = (torch.randn((lm,) * 3, generator=gen, device="cuda",
                                dtype=dtype) for _ in range(2))
            r = k2.p2_residual(v, f, a_t, offs)
            cases = [
                ("p2_residual", r, k2.p2_residual_ref(v, f, a_t, offs)),
                ("p2_jacobi_sweep", k2.p2_jacobi_sweep(v, f, a_t, offs, w),
                 k2.p2_jacobi_sweep_ref(v, f, a_t, offs, w)),
                ("p2_mass_quad", k2.p2_mass_quad(r, m_t, m_offs),
                 k2.p2_mass_quad_ref(r, m_t, m_offs)),
                ("p2_mass_quad", k2.p2_mass_quad(f, m_t, m_offs),
                 k2.p2_mass_quad_ref(f, m_t, m_offs)),
            ]
            torch.cuda.synchronize()
            parts = []
            for name, out, ref in cases:
                check_close(name, out, ref, 0.0, err, parts,
                            f"lm={lm} {dtype}")
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"{name} at lm={lm}: non-finite")
            print(f"phase 17 lm={lm} {str(dtype)[6:]}: max|kernel-plain| "
                  + " ".join(parts) + f"; q(r)={float(cases[2][1])!r}")
            del v, f, r, cases
            torch.cuda.empty_cache()
    counts = kcuda.launch_counts()
    missing = [k for k in KERNELS_P2 if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"launch counters did not move: {missing}")

    lm = TIMED_LM_P2
    offs, a_t, m_offs, m_t = p2_tables(torch, lm, torch.float32)
    v, f = (torch.randn((lm,) * 3, generator=gen, device="cuda")
            for _ in range(2))
    out = torch.empty_like(v)
    pairs = {
        "p2_residual": (lambda: k2.p2_residual(v, f, a_t, offs),
                        lambda: k2.p2_residual_ref(v, f, a_t, offs)),
        "p2_jacobi_sweep": (
            lambda: k2.p2_jacobi_sweep(v, f, a_t, offs, w, out),
            lambda: k2.p2_jacobi_sweep_ref(v, f, a_t, offs, w)),
        "p2_mass_quad": (lambda: k2.p2_mass_quad(v, m_t, m_offs),
                         lambda: k2.p2_mass_quad_ref(v, m_t, m_offs)),
    }
    for name in KERNELS_P2:
        OPS[name] = p2_ops_per_node(m_t if name == "p2_mass_quad" else a_t,
                                    lm, name)
    print("phase 17 f32 operations a node at lm=513 (nonzero weights): "
          + ", ".join(f"{k} {OPS[k]:.3f}" for k in KERNELS_P2))
    library = {"p2_residual": p2_conv_library(torch, v, a_t, offs)}
    time_pairs(torch, pairs, err, records, f"phase 17 time at lm={lm} f32",
               {k: (lm ** 3, 0) for k in pairs}, library)
    del v, f, out
    torch.cuda.empty_cache()
    return {"max_abs_err": {k: err[k] for k in KERNELS_P2}}


def p2_config(mg, finest_level, dtype, rtol):
    """poisson3d_p2 with coarsest_elements 8 (a 17^3 coarsest lattice) and
    V(2,2) snap-Jacobi, P^T."""
    cyc = mg.CycleSpec(nu1=2, nu2=2, smoother="jacobi", restriction="pt",
                       tol=0.0, rtol=rtol, max_cycles=40, track_error=False)
    return mg.models.poisson3d_p2(finest_level=finest_level,
                                  coarsest_level=0, coarsest_elements=8,
                                  dtype=dtype, cycle=cyc), cyc


def p2_state(hier):
    """A port P2 hierarchy's state as numpy (utils.convert's format)."""
    return {
        "levels": [{"b": lv.b.cpu().numpy(), "g": lv.g.cpu().numpy(),
                    "n": lv.n, "lm": lv.n + 1, "offsets": lv.A.offsets,
                    "parity_tables": lv.A.parity_tables.cpu().numpy()}
                   for lv in hier.levels],
        "coarse": {"factor": hier.coarse.factor.cpu().numpy(), "piv": None,
                   "kind": hier.coarse.kind},
        "m_parity_tables": hier.M_fine.parity_tables.cpu().numpy(),
        "m_offsets": hier.M_fine.offsets,
    }


def phase_small_p2(torch, np, mg):
    """The P2 slice at the 65^3 lattice in f32, V(2,2) snap Jacobi, rtol
    1e-6: the CPU-built hierarchy carried to the card against the CPU's
    solve, and the card-built one."""
    torch.set_num_threads(8)
    cfg, cyc = p2_config(mg, 2, "float32", 1e-6)
    h_cpu = mg.build_p2_hierarchy(cfg, device="cpu")
    cpu = mg.solve(h_cpu, cyc)
    carried = mg.solve(mg.hierarchy_from_numpy(p2_state(h_cpu), cfg), cyc)
    h_card = mg.build_p2_hierarchy(cfg)
    built = mg.solve(h_card, cyc)
    k = cpu.num_cycles
    hc = cpu.res_hist[:k].double().numpy()
    hg = carried.res_hist[:carried.num_cycles].double().cpu().numpy()
    hb = built.res_hist[:built.num_cycles].double().cpu().numpy()
    db = max(float((a.b.cpu() - c.b).abs().max())
             for a, c in zip(h_card.levels, h_cpu.levels))
    bitwise = carried.num_cycles == k and np.array_equal(hg, hc)
    print(f"phase 18 65^3 P2 f32 jacobi: cpu {k} cycles {hc.tolist()}; "
          f"carried to the card {carried.num_cycles} {hg.tolist()} (bitwise "
          f"{bitwise}); card-built {built.num_cycles} {hb.tolist()}; "
          f"max|b_card - b_cpu| {db:.3e}")
    if not (cpu.converged and carried.converged and built.converged):
        raise AssertionError("65^3 P2 did not converge")
    if carried.num_cycles != k or built.num_cycles != k:
        raise AssertionError(f"65^3 P2: card {carried.num_cycles} / "
                             f"{built.num_cycles} cycles, cpu {k}")
    rel = np.abs(hg - hc) / np.abs(hc)
    if not np.all(rel <= RTOL_P2_SMALL):
        raise AssertionError(f"65^3 P2 res_hist differs: rel {rel.tolist()}")
    return {"cycles": k, "res_hist": hc.tolist(), "bitwise": bitwise,
            "card_built_res_hist": hb.tolist(), "max_abs_b_diff": db}


def p2_run(torch, mg, hier, cyc, label, fn):
    """fn(hier, cyc) with the launch counts set to 0 just before and read
    just after, and no plain kernel version called in between."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda

    torch.cuda.synchronize()
    kcuda.reset_launch_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        res = fn(hier, cyc)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = kcuda.launch_counts()
    if plain.calls:
        raise AssertionError(f"{label} ran plain versions: {plain.calls}")
    missing = [k for k in KERNELS_P2 + ("restrict_pt", "prolong_linear_add",
                                        "prolong_linear")
               if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{label} did not launch {missing}")
    return res, secs, counts


def p2_max_error(torch, u):
    """max|u - u*| over the lattice nodes, u* = 1 + x^2 + 2y^2 + 3z^2 in
    f64 (it lies in the P2 space, so the discrete solution equals it)."""
    lm = u.shape[0]
    ax = torch.arange(lm, device=u.device, dtype=torch.float64) / (lm - 1)
    ustar = (1.0 + ax.view(-1, 1, 1) ** 2 + 2.0 * ax.view(1, -1, 1) ** 2
             + 3.0 * ax.view(1, 1, -1) ** 2)
    return float((u.double() - ustar).abs().max())


def p2_more_cycles(torch, mg, hier, cyc, u):
    """res_hist, u(1/2,1/2,1/2) and max|u - u*| after 4 more V-cycles from
    u: where the iteration settles below the rtol."""
    more = mg.resume_solve(hier, dataclasses.replace(cyc, rtol=0.0,
                                                     max_cycles=4), u)
    mid = hier.finest.n // 2
    out = {"res_hist": more.res_hist[:more.num_cycles].double().cpu()
           .numpy().tolist(), "u_mid": float(more.u[mid, mid, mid]),
           "max_abs_u_minus_ustar": p2_max_error(torch, more.u)}
    print(f"phase 19 {str(u.dtype)[6:]} 4 more cycles: res_hist "
          f"{out['res_hist']}, u(1/2,1/2,1/2)={out['u_mid']!r}, max|u-u*| "
          f"{out['max_abs_u_minus_ustar']:.4e}")
    return out


def phase_p2(torch, np, mg, card):
    """BASELINE config 4's constant-coefficient P2 path at full width:
    513^3 lattice f32, FMG + V(2,2) snap-Jacobi tolerance solve to rtol
    2e-8, then MG-CG from FMG on the same hierarchy; 4 more cycles from
    the solve's u, and the same solve in f64, say what limits max|u -
    u*|."""
    from multigrid_dolfinx_tpu_torch.solver import hierarchy as hmod
    from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm

    cfg, cyc = p2_config(mg, 5, "float32", 2e-8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    factor_s = [0.0]
    build_coarse = hmod.build_coarse_solver

    def timed_coarse(*a, **kw):
        t = time.perf_counter()
        c = build_coarse(*a, **kw)
        factor_s[0] += time.perf_counter() - t
        return c

    hmod.build_coarse_solver = timed_coarse
    try:
        t0 = time.perf_counter()
        hier = mg.build_p2_hierarchy(cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        hmod.build_coarse_solver = build_coarse
    res, solve_s, counts = p2_run(torch, mg, hier, cyc, "P2 solve", mg.solve)
    lm = hier.finest.n + 1
    mid = lm // 2
    u_mid = float(res.u[mid, mid, mid])
    du = p2_max_error(torch, res.u)
    hist = res.res_hist[:res.num_cycles].double().cpu().numpy().tolist()
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = {"levels": [lv.n + 1 for lv in hier.levels], "build_s": build_s,
           "coarse_factor_s": factor_s[0], "solve_s": solve_s,
           "cycles": res.num_cycles, "converged": res.converged,
           "res_hist": hist, "u_mid": u_mid, "max_abs_u_minus_ustar": du,
           "peak_gb": peak,
           "launches": {k: c for k, c in counts.items() if c}}
    print(f"phase 19 P2 513^3 f32: levels {out['levels']}, build "
          f"{build_s:.3f} s (coarse factor {factor_s[0]:.3f} s), solve "
          f"{solve_s:.3f} s, {res.num_cycles} cycles after FMG, converged="
          f"{res.converged} diverged={res.diverged}, res_hist {hist}, "
          f"u(1/2,1/2,1/2)={u_mid!r}, max|u-u*| {du:.4e}, peak {peak:.2f} "
          f"GB, launches {out['launches']}")
    if not res.converged or res.diverged:
        raise AssertionError("P2 513^3 solve did not converge")
    if res.num_cycles > 3:
        raise AssertionError(f"P2 513^3 took {res.num_cycles} cycles (> 3)")
    if not abs(u_mid - 2.5) < 1e-2:
        raise AssertionError(f"P2 u(1/2,1/2,1/2) = {u_mid} is not 2.5 +- 1e-2")

    out["more_cycles"] = p2_more_cycles(torch, mg, hier, cyc, res.u)
    ms, rooted = time_vcycles(torch, mg, hier, cyc, res.u)
    check = time_ms(torch, lambda: check_norm(hier, res.u, hier.finest.b),
                    reps=3, warmup=1)
    dofs = lm ** 3
    out.update(ms_per_vcycle=ms, dof_per_s=dofs / (ms * 1e-3), check_ms=check,
               ms_per_vcycle_rooted_at_lm=rooted)
    print(f"phase 19 V-cycle: {ms:.4f} ms/V-cycle, {dofs / (ms * 1e-3):.4e} "
          f"DOF/s at {dofs} DOFs on [{card}]; check {check:.4f} ms; rooted "
          "at lm (ms): " + ", ".join(f"{k}: {t:.4f}"
                                     for k, t in rooted.items()))
    del res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cg, cg_s, cg_counts = p2_run(torch, mg, hier, cyc, "P2 MG-CG",
                                 mg.mgcg_solve)
    cg_mid = float(cg.u[mid, mid, mid])
    cg_hist = cg.res_hist[:cg.num_iters].double().cpu().numpy().tolist()
    out["mgcg"] = {"iters": cg.num_iters, "converged": cg.converged,
                   "solve_s": cg_s, "res_hist": cg_hist, "u_mid": cg_mid,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "launches": {k: c for k, c in cg_counts.items() if c}}
    print(f"phase 19 P2 MG-CG from FMG: {cg.num_iters} iterations, "
          f"converged={cg.converged} diverged={cg.diverged}, {cg_s:.3f} s, "
          f"res_hist {cg_hist}, u(1/2,1/2,1/2)={cg_mid!r}, peak "
          f"{out['mgcg']['peak_gb']:.2f} GB, launches "
          f"{out['mgcg']['launches']}")
    if not cg.converged or cg.diverged or not abs(cg_mid - 2.5) < 1e-2:
        raise AssertionError("P2 513^3 MG-CG did not converge to u = 2.5")
    del cg, hier
    torch.cuda.empty_cache()

    # the same solve in f64: whether f32 or the rtol limits max|u - u*|
    cfg64, cyc64 = p2_config(mg, 5, "float64", 2e-8)
    h64 = mg.build_p2_hierarchy(cfg64)
    r64 = mg.solve(h64, cyc64)
    out["f64"] = {"cycles": r64.num_cycles, "converged": r64.converged,
                  "res_hist": r64.res_hist[:r64.num_cycles].cpu().numpy()
                  .tolist(), "u_mid": float(r64.u[mid, mid, mid]),
                  "max_abs_u_minus_ustar": p2_max_error(torch, r64.u),
                  "more_cycles": p2_more_cycles(torch, mg, h64, cyc64,
                                                r64.u)}
    print(f"phase 19 P2 513^3 f64, rtol 2e-8: {r64.num_cycles} cycles, "
          f"res_hist {out['f64']['res_hist']}, u(1/2,1/2,1/2)="
          f"{out['f64']['u_mid']!r}, max|u-u*| "
          f"{out['f64']['max_abs_u_minus_ustar']:.4e}")
    if not r64.converged or not abs(out["f64"]["u_mid"] - 2.5) < 1e-2:
        raise AssertionError("P2 513^3 f64 did not converge to u = 2.5")
    del h64, r64
    torch.cuda.empty_cache()
    return {k: counts[k] for k in KERNELS_P2}, out


def var_kappa_2d(x, y):
    """kappa = 1 + x + 2y, the JAX package's 2D planes fixture."""
    return 1.0 + x + 2.0 * y


def planes2_sets(mg):
    from multigrid_dolfinx_tpu_torch.fem.fast_var import structural_offsets

    axis5 = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
    box9 = tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))
    radius2 = tuple((a, b) for a in range(-2, 3) for b in range(-2, 3)
                    if abs(a) + abs(b) <= 2)
    return {"axis5": axis5, "p1_7": structural_offsets(2, "right"),
            "box9": box9, "radius2": radius2}


def planes2_bound(name, k, n):
    """(bound_ms, bound_by) of K22-K24 on n f32 points with k planes:
    bytes of k planes, v, f and the output over PEAK_BYTES_S; operations,
    a multiply and an add per offset (the Jacobi sweep's centre left out)
    plus 1 (residual), 6 (Jacobi, with the division) or 4 (GS)."""
    ops = {"planes2_residual": 2 * k + 1, "planes2_jacobi_sweep": 2 * k + 4,
           "planes2_gs_sweep": 2 * k + 4}[name]
    t_bytes = 4.0 * (k + 3) * n / PEAK_BYTES_S * 1e3
    t_ops = ops * n / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_planes2(torch, gen, offs, lm, dtype):
    """Random planes on the card with a dominant centre plane, and random
    v and f; not eliminated, so out-of-box neighbours are reached."""
    dev = torch.device("cuda")
    planes = torch.randn((len(offs), lm, lm), generator=gen, device=dev,
                         dtype=dtype)
    planes[offs.index((0, 0))].abs_().add_(float(len(offs)))
    v, f = (torch.randn((lm, lm), generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    return planes, v, f


def planes2_cases(sp, v, f, planes, offs, w):
    """(name, kernel output, plain output) of K22-K24 on one input."""
    return [
        ("planes2_residual", sp.planes2_residual(v, f, planes, offs),
         sp.planes2_residual_ref(v, f, planes, offs)),
        ("planes2_jacobi_sweep",
         sp.planes2_jacobi_sweep(v, f, planes, offs, w),
         sp.planes2_jacobi_sweep_ref(v, f, planes, offs, w)),
        ("planes2_gs_sweep", sp.planes2_gs_sweep(v.clone(), f, planes, offs),
         sp.planes2_gs_sweep_ref(v.clone(), f, planes, offs)),
    ]


def phase_planes2_kernels(torch, np, mg, records):
    """K22-K24 against their plain versions on the card, bitwise, in f32
    and f64 at PLANES2_LMS in all three colour schedules, then kernel /
    plain times at 8193^2 (7 offsets) and 4097^2 (9 offsets) f32."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil2d_planes as sp

    sets = planes2_sets(mg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    w = 2.0 / 3.0
    err = {}
    kcuda.reset_launch_counts()
    for dtype in (torch.float32, torch.float64):
        for lm in PLANES2_LMS:
            parts = []
            for name, offs in sets.items():
                if name == "radius2" and lm > 4097:
                    continue
                planes, v, f = random_planes2(torch, gen, offs, lm, dtype)
                cases = planes2_cases(sp, v, f, planes, offs, w)
                torch.cuda.synchronize()
                for kname, out, ref in cases:
                    check_close(kname, out, ref, 0.0, err, parts,
                                f"lm={lm} {name} {dtype}")
                    if not bool(torch.isfinite(out).all()):
                        raise AssertionError(f"{kname} at lm={lm} {name}: "
                                             "non-finite output")
                parts[-3:] = [f"{name}({sp.planes2_colors(offs)[0]}):" +
                              ",".join(q.split("=")[1] for q in parts[-3:])]
                del planes, v, f, cases
                torch.cuda.empty_cache()
            print(f"phase 20 lm={lm} {str(dtype)[6:]}: max|kernel-plain| "
                  "(residual,jacobi,gs) " + " ".join(parts))
    counts = kcuda.launch_counts()
    missing = [k for k in KERNELS_PLANES2 if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"launch counters did not move: {missing}")

    timed = {}
    for lm, name in ((TIMED_LM_2D, "p1_7"), ((TIMED_LM_2D + 1) // 2, "box9")):
        offs = sets[name]
        planes, v, f = random_planes2(torch, gen, offs, lm, torch.float32)
        out = torch.empty_like(v)
        vg, vr = v.clone(), v.clone()   # K24 and its plain version in place
        pairs = {
            "planes2_residual": (
                lambda: sp.planes2_residual(v, f, planes, offs),
                lambda: sp.planes2_residual_ref(v, f, planes, offs)),
            "planes2_jacobi_sweep": (
                lambda: sp.planes2_jacobi_sweep(v, f, planes, offs, w, out),
                lambda: sp.planes2_jacobi_sweep_ref(v, f, planes, offs, w)),
            "planes2_gs_sweep": (
                lambda: sp.planes2_gs_sweep(vg, f, planes, offs),
                lambda: sp.planes2_gs_sweep_ref(vr, f, planes, offs)),
        }
        bounds = {k: planes2_bound(k, len(offs), lm * lm) for k in pairs}
        # the finest level's times go into the kernels' records
        recs = records if lm == TIMED_LM_2D else {}
        time_pairs(torch, pairs, err, recs,
                   f"phase 20 time at lm={lm} f32, {len(offs)} planes", {},
                   bounds=bounds)
        if lm != TIMED_LM_2D:
            timed[lm] = {k: {q: r[q] for q in ("ms", "plain_ms", "bound_ms")}
                         for k, r in recs.items()}
        del planes, v, f, out, vg, vr
        torch.cuda.empty_cache()
    return {"max_abs_err": {k: err[k] for k in KERNELS_PLANES2},
            "timed_4097": timed}


def var2d_config(mg, finest_level, dtype, smoother="rbgs"):
    """models.variable_coefficient_2d at (8 * 2^finest_level + 1)^2, 11
    levels at finest_level 10: Galerkin, V(2,2), P^T, FMG + tolerance
    solve to RTOL_VAR2D[dtype]."""
    cyc = mg.CycleSpec(nu1=2, nu2=2, smoother=smoother, restriction="pt",
                       tol=0.0, rtol=RTOL_VAR2D[dtype], max_cycles=40,
                       track_error=False)
    return mg.models.variable_coefficient_2d(
        var_kappa_2d, finest_level=finest_level, coarsest_level=0,
        coarsest_elements=8, dtype=dtype, cycle=cyc), cyc


def check_jax_count(label, dtype, smoother, k):
    want = JAX_COUNTS_2049[(dtype, smoother)]
    if k != want:
        raise AssertionError(f"{label}: {k} cycles, the JAX package's plain "
                             f"path takes {want}")


def phase_small_var2d(torch, np, mg):
    """2049^2, V(2,2) multicolour GS, f32 (rtol 1e-5) and f64 (rtol 1e-8):
    the hierarchy built on the CPU and carried to the card solves as the
    port's plain path on the CPU (same count, histories to 1e-4 in f32 as
    phase 8, bitwise expected as in phase 15; in f64 to 1e-9 with an
    absolute floor of 1e-15 ||b||_M, the tests' rule: the f64 coarse
    solve and the norm's sum round in another order on the card); the
    card-built hierarchy (its Galerkin convolution sums in another order
    than the CPU's, so its f32 planes differ by roundings) takes the same
    count; both counts equal the JAX package's.  The Jacobi variant on
    the card is held to the JAX package's counts too."""
    from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm

    def hist(r):
        return r.res_hist[:r.num_cycles].double().cpu().numpy().tolist()

    torch.set_num_threads(8)
    out = {}
    for dtype, rtol_h in (("float32", 1e-4), ("float64", 1e-9)):
        cfg, cyc = var2d_config(mg, 8, dtype)
        h_cpu = mg.build_var_hierarchy(cfg, device="cpu")
        c = mg.solve(h_cpu, cyc)
        atol = 0.0 if dtype == "float32" else 1e-15 * float(check_norm(
            h_cpu, torch.zeros_like(h_cpu.finest.b), h_cpu.finest.b))
        carried = mg.solve(mg.hierarchy_from_numpy(var_state(h_cpu), cfg),
                           cyc)
        del h_cpu
        rel = compare_histories(np, f"2049^2 var {dtype} carried", carried,
                                c, rtol_h, atol)
        du = float((carried.u.cpu().double() - c.u.double()).abs().max())
        g = mg.solve(mg.build_var_hierarchy(cfg), cyc)
        if not g.converged or g.num_cycles != c.num_cycles:
            raise AssertionError(f"2049^2 var {dtype}: card-built "
                                 f"{g.num_cycles} cycles, cpu {c.num_cycles}")
        check_jax_count(f"2049^2 var {dtype} rbgs", dtype, "rbgs",
                        g.num_cycles)
        cfg_j, cyc_j = var2d_config(mg, 8, dtype, "jacobi")
        rj = mg.solve(mg.build_var_hierarchy(cfg_j), cyc_j)
        if not rj.converged:
            raise AssertionError(f"2049^2 var {dtype} jacobi did not converge")
        check_jax_count(f"2049^2 var {dtype} jacobi", dtype, "jacobi",
                        rj.num_cycles)
        out[dtype] = {"cycles": c.num_cycles, "jacobi_cycles": rj.num_cycles,
                      "res_hist_cpu": hist(c),
                      "res_hist_carried": hist(carried),
                      "res_hist_card_built": hist(g), "max_rel_diff": rel,
                      "max_abs_u_carried_minus_cpu": du,
                      "jacobi_res_hist": hist(rj)}
        print(f"phase 21 2049^2 var kappa {dtype} (rtol {cyc.rtol}): rbgs "
              f"{c.num_cycles} cycles on the cpu, carried to the card and "
              f"card-built (JAX {JAX_COUNTS_2049[(dtype, 'rbgs')]}); res_hist "
              f"cpu {hist(c)} carried {hist(carried)} card-built {hist(g)};"
              f" max rel diff carried/cpu {rel}; max|u_carried-u_cpu| "
              f"{du:.3e}; jacobi on the card {rj.num_cycles} cycles (JAX "
              f"{JAX_COUNTS_2049[(dtype, 'jacobi')]}) {hist(rj)}")
        del g, c, carried, rj
    return out


def run_var2d(torch, mg, dtype, label, hier=None, smoother="rbgs",
              solve=None):
    """Build (unless given) and solve the 8193^2 configuration, the launch
    counts set to 0 just before and read just after, with no plain kernel
    version running on the card."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda

    cfg, cyc = var2d_config(mg, FINEST_LEVEL_2D, dtype, smoother)
    solve = solve or mg.solve
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kcuda.reset_launch_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        if hier is None:
            hier = mg.build_var_hierarchy(cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = solve(hier, cyc)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    counts = kcuda.launch_counts()
    if plain.calls:
        raise AssertionError(f"8193^2 var {label}: plain versions ran on the "
                             f"card: {plain.calls}")
    k = count_of(res)
    mid = hier.finest.n // 2
    run = {"build_s": t1 - t0, "solve_s": t2 - t1, "count": k,
           "converged": res.converged,
           "res_hist": res.res_hist[:k].double().cpu().numpy().tolist(),
           "u_mid": float(res.u[mid, mid]),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "levels": [(lv.n + 1, len(lv.A.offsets)) for lv in hier.levels],
           "launches": {n: c for n, c in counts.items() if c}}
    print(f"phase 22 8193^2 var {dtype} {label}: (lm, planes) "
          f"{run['levels']}, build {run['build_s']:.3f} s, solve "
          f"{run['solve_s']:.3f} s, {k} cycles or iterations after FMG, "
          f"converged={res.converged} diverged={res.diverged}, res_hist "
          f"{run['res_hist']}, u(1/2,1/2)={run['u_mid']!r}, peak "
          f"{run['peak_gb']:.2f} GB, launches {run['launches']}")
    lm = 8 * 2 ** FINEST_LEVEL_2D + 1
    if (not res.converged or res.diverged or tuple(res.u.shape) != (lm, lm)
            or not bool(torch.isfinite(res.u).all())):
        raise AssertionError(f"8193^2 var {dtype} {label} did not converge "
                             "to a finite solution")
    return hier, res, counts, run


def check_levels_2d(torch, hier, err, label):
    """K22-K24 on every level of `hier` with the level's own planes and b
    and a random v, K8 of K22's residual to the level below and K9 from a
    random coarse field, each bitwise against its plain version."""
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil2d as s2
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil2d_planes as sp

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for li, lv in enumerate(hier.levels):
        A, f, lm = lv.A, lv.b, lv.n + 1
        v = torch.randn(f.shape, generator=gen, device="cuda", dtype=f.dtype)
        cases = planes2_cases(sp, v, f, A.planes, A.offsets, lv.sm.omega)
        if li > 0:
            lmc = hier.levels[li - 1].n + 1
            c = torch.randn((lmc, lmc), generator=gen, device="cuda",
                            dtype=f.dtype)
            r = cases[0][1]
            cases += [("restrict_pt_2d", s2.restrict_pt(r, lm, lmc),
                       s2.restrict_pt_ref(r, lm, lmc)),
                      ("prolong_linear_2d", s2.prolong_linear(c, lm),
                       s2.prolong_linear_ref(c, lm))]
        torch.cuda.synchronize()
        parts = []
        for name, out, ref in cases:
            check_close(name, out, ref, 0.0, err, parts, f"{label} lm={lm}")
        print(f"phase 22 {label} level lm={lm} ({len(A.offsets)} planes): "
              "max|kernel-plain| " + " ".join(parts))
        del v, cases
        torch.cuda.empty_cache()


def phase_var2d(torch, np, mg, card, records):
    """2D variable kappa at full width, 8193^2: f32 multicolour GS (the
    slice's main path: launches, times, the f32 floor), its kernels on
    every level, the Jacobi variant and MG-CG from FMG on the same
    hierarchy, then the f64 twin."""
    from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm

    err = {}
    hier, res, counts, out = run_var2d(torch, mg, "float32", "V(2,2) rbgs")
    if out["count"] > 3:
        raise AssertionError(f"8193^2 var f32 took {out['count']} cycles "
                             "(> 3)")
    missing = [k for k in ("planes2_residual", "planes2_gs_sweep",
                           "restrict_pt_2d", "prolong_linear_2d")
               if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"8193^2 var path did not launch {missing}")
    _, cyc = var2d_config(mg, FINEST_LEVEL_2D, "float32")
    rn_ref = float(check_norm(hier, torch.zeros_like(hier.finest.b),
                              hier.finest.b))
    ms, rooted = time_vcycles(torch, mg, hier, cyc, res.u)
    check = time_ms(torch, lambda: check_norm(hier, res.u, hier.finest.b),
                    reps=5, warmup=1)
    more = mg.resume_solve(hier, dataclasses.replace(cyc, rtol=1e-12,
                                                     max_cycles=6), res.u)
    floor = (more.res_hist[:more.num_cycles].double().cpu().numpy()
             / rn_ref).tolist()
    dofs = (hier.finest.n + 1) ** 2
    out.update(rn_ref=rn_ref, ms_per_vcycle=ms, dof_per_s=dofs / (ms * 1e-3),
               ms_per_vcycle_rooted_at_lm=rooted, check_ms=check,
               floor_rel_residuals=floor)
    print(f"phase 22 V-cycle f32: {ms:.4f} ms/V-cycle, "
          f"{dofs / (ms * 1e-3):.4e} DOF/s at {dofs} DOFs on [{card}]; check "
          f"{check:.4f} ms; rooted at lm (ms): " + ", ".join(
              f"{k}: {t:.4f}" for k, t in rooted.items()))
    print(f"phase 22 f32: ||b||_M {rn_ref!r}; relative residual of 6 more "
          f"cycles {floor}")
    u32 = res.u
    del res, more
    check_levels_2d(torch, hier, err, "f32")

    counts_j, out["jacobi"] = run_var2d(
        torch, mg, "float32", "V(2,2) jacobi", hier=hier,
        smoother="jacobi")[2:]
    if counts_j.get("planes2_jacobi_sweep", 0) == 0:
        raise AssertionError("8193^2 var jacobi run did not launch K23")
    out["mgcg"] = run_var2d(torch, mg, "float32", "MG-CG from FMG",
                            hier=hier, solve=mg.mgcg_solve)[3]
    del hier
    torch.cuda.empty_cache()

    hier64, res64, _, out["f64"] = run_var2d(torch, mg, "float64",
                                             "V(2,2) rbgs")
    check_levels_2d(torch, hier64, err, "f64")
    du = float((res64.u - u32.double()).abs().max())
    out["max_abs_u_f32_minus_f64"] = du
    print(f"phase 22 f32 vs f64: u(1/2,1/2) {out['u_mid']!r} vs "
          f"{out['f64']['u_mid']!r}; max|u_f32 - u_f64| {du:.3e}")
    del hier64, res64, u32
    torch.cuda.empty_cache()
    for k, e in err.items():
        if k in records:
            records[k]["max_abs_err"] = max(records[k]["max_abs_err"], e)
    out["levels_max_abs_err"] = err
    launches = {k: counts[k] for k in KERNELS_PLANES2}
    launches["planes2_jacobi_sweep"] = counts_j["planes2_jacobi_sweep"]
    return launches, out


def dist_blocks(torch, a, P, z, h):
    """[(block, lo, hi)] of the global array a padded with zero rows to z
    and split over P ranks, with h-deep halos (zeros past the edges): what
    each rank holds and what the halo exchange hands it."""
    pad = torch.zeros((z + 2 * h,) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    pad[h:h + a.shape[0]] = a
    mz = z // P
    return [tuple(pad[lo:hi].contiguous() for lo, hi in (
        (h + r * mz, h + (r + 1) * mz), (r * mz, h + r * mz),
        (h + (r + 1) * mz, 2 * h + (r + 1) * mz))) for r in range(P)]


def dist_cases(sd, blk, lm, wc, woff, w, zb):
    """(name, kernel call, plain call) of K25-K29 on one rank's block."""
    (v, vlo2, vhi2), (f, flo2, fhi2), (_, vlo1, vhi1), (_, flo1, fhi1), \
        (c, _, chi) = blk
    lmc = (lm + 1) // 2
    a2 = (v, f, vlo2, vhi2, flo2, fhi2)
    a1 = (v, f, vlo1, vhi1, flo1, fhi1)
    return [
        ("rb_sweep_dist", lambda: sd.rb_sweep_dist(*a2, lm, wc, woff, zb),
         lambda: sd.rb_sweep_dist_ref(*a2, lm, wc, woff, zb)),
        ("jacobi_sweep_dist",
         lambda: sd.jacobi_sweep_dist(*a1, lm, wc, woff, w, zb),
         lambda: sd.jacobi_sweep_dist_ref(*a1, lm, wc, woff, w, zb)),
        ("residual_dist", lambda: sd.residual_dist(*a1, lm, wc, woff, zb),
         lambda: sd.residual_dist_ref(*a1, lm, wc, woff, zb)),
        ("restrict_residual_pt_dist",
         lambda: sd.restrict_residual_pt_dist(*a2, lm, lmc, wc, woff, zb),
         lambda: sd.restrict_residual_pt_dist_ref(*a2, lm, lmc, wc, woff,
                                                  zb)),
        ("prolong_linear_dist",
         lambda: sd.prolong_linear_dist(c, chi[:1], lm, zb, v),
         lambda: sd.prolong_linear_dist_ref(c, chi[:1], lm, zb, v)),
    ]


def dist_z(mg, lm, P):
    """The padded z that parallel.halo3d's plan gives the lm^3 level over
    P ranks: that of the main path's 512^3 hierarchy where the level is
    sharded there, else that of the hierarchy whose finest level it is."""
    from multigrid_dolfinx_tpu_torch.parallel.halo3d import ZPlan

    for lm_f in (TIMED_LM, lm):
        fl = (lm_f - 1).bit_length() - 4      # 8 * 2^fl elements per axis
        plan = ZPlan.of(mg.models.poisson3d(
            finest_level=fl, coarsest_level=0, coarsest_elements=8), P)
        z = plan.zs[plan.lms.index(lm)]
        if z is not None:
            return z
    raise AssertionError(f"no plan shards lm={lm} over {P} ranks")


def phase_dist_kernels(torch, np, mg, records):
    """K25-K29 against their plain versions on every rank's block (edge
    and interior ranks, P in {2, 4}) in f32 and f64 at lm in DIST_LMS,
    split as the plan splits them (dist_z), bitwise; stitched over the ranks, bitwise the single-device K1, K11,
    K10, K2 and K3 on the same global data (plan padding rows 0); kernel,
    plain and bound times at DIST_TIMED in f32."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d as s3
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_dist as sd

    rng = np.random.default_rng(SEED + 23)
    dev = torch.device("cuda")
    w = 2.0 / 3.0
    err = {}
    kcuda.reset_launch_counts()
    for dtype in (torch.float32, torch.float64):
        for lm in DIST_LMS:
            wc, woff = level_weights(mg, lm)
            lmc = (lm + 1) // 2
            v, f = (torch.from_numpy(rng.standard_normal((lm,) * 3)).to(
                dev, dtype) for _ in range(2))
            c = torch.from_numpy(rng.standard_normal((lmc,) * 3)).to(
                dev, dtype)
            single = {
                "rb_sweep_dist": s3.rb_sweep(v, f, lm, wc, woff),
                "jacobi_sweep_dist": s3.jacobi_sweep(v, f, lm, wc, woff, w),
                "residual_dist": s3.residual(v, f, lm, wc, woff),
                "restrict_residual_pt_dist": s3.restrict_residual_pt(
                    v, f, lm, lmc, wc, woff),
                "prolong_linear_dist": s3.prolong_linear(c, lm, v),
            }
            parts = []
            for P in (2, 4):
                z = dist_z(mg, lm, P)
                blocks = list(zip(
                    dist_blocks(torch, v, P, z, 2),
                    dist_blocks(torch, f, P, z, 2),
                    dist_blocks(torch, v, P, z, 1),
                    dist_blocks(torch, f, P, z, 1),
                    dist_blocks(torch, c, P, z // 2, 1)))
                outs = {k: [] for k in KERNELS_DIST}
                for r in range(P):
                    for name, kern, plain in dist_cases(
                            sd, blocks[r], lm, wc, woff, w, r * (z // P)):
                        out, ref = kern(), plain()
                        check_close(name, out, ref, 0.0, err, [],
                                    f"lm={lm} P={P} rank={r} {dtype}")
                        outs[name].append(out)
                for name in KERNELS_DIST:
                    got = torch.cat(outs[name])
                    want = single[name]
                    n = want.shape[0]
                    if not (torch.equal(got[:n], want)
                            and not got[n:].any()):
                        raise AssertionError(
                            f"{name} stitched over {P} ranks at lm={lm} "
                            f"{dtype} is not the single-device kernel")
                parts.append(f"P={P} ({P} x ({z // P}, {lm}, {lm})): "
                             "5 kernels bitwise, stitched == single-device")
            print(f"phase 23 lm={lm} {str(dtype)[6:]}: " + "; ".join(parts))
            del v, f, c, single, blocks, outs
            torch.cuda.empty_cache()
    counts = kcuda.launch_counts()
    missing = [k for k in KERNELS_DIST if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"launch counters did not move: {missing}")

    timed = {}
    for mz, lm in DIST_TIMED:
        wc, woff = level_weights(mg, lm)
        lmc = (lm + 1) // 2

        def rand(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev)

        v, f = rand(mz, lm, lm), rand(mz, lm, lm)
        blk = ((v, rand(2, lm, lm), rand(2, lm, lm)),
               (f, rand(2, lm, lm), rand(2, lm, lm)))
        blk += ((v, blk[0][1][1:].contiguous(), blk[0][2][:1].contiguous()),
                (f, blk[1][1][1:].contiguous(), blk[1][2][:1].contiguous()),
                (rand(mz // 2, lmc, lmc), None, rand(1, lmc, lmc)))
        # an interior rank's block: z_base = mz
        pairs = {name: (kern, plain) for name, kern, plain in
                 dist_cases(sd, blk, lm, wc, woff, w, mz)}
        n, nc = mz * lm * lm, (mz // 2) * lmc * lmc
        shape = {k: (n, nc if k in ("restrict_residual_pt_dist",
                                    "prolong_linear_dist") else 0)
                 for k in pairs}
        recs = records if lm == TIMED_LM else {}
        time_pairs(torch, pairs, err, recs,
                   f"phase 23 time at ({mz}, {lm}, {lm}) f32", shape)
        if recs is not records:
            timed[f"{mz}x{lm}x{lm}"] = {k: {key: r[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by")}
                for k, r in recs.items()}
        del v, f, blk, pairs
        torch.cuda.empty_cache()
    return timed


def dist_record(res):
    """count, converged and history of a distributed run, picklable."""
    k = count_of(res)
    return {"count": k, "converged": res.converged,
            "hist": res.res_hist[:k].double().cpu().numpy().tolist()}


def dist_rank(rank, world_size, device, out_dir):
    """One rank of phases 24 and 25 (run_ranks, gloo, every rank on the
    card): the 64^3 distributed solve on ranks 0-1 on the card and on the
    CPU, then the 512^3 distributed path on all ranks."""
    import torch
    import torch.distributed as dist

    import multigrid_dolfinx_tpu_torch as mg

    torch.set_num_threads(2)
    out = {}

    # phase 24: 64^3 f32 over ranks 0-1, card and CPU
    pair = dist.new_group([0, 1])
    if rank < 2:
        small = {}
        for dev in ("cuda", "cpu"):
            cfg = mg.models.poisson3d(
                finest_level=3, coarsest_level=0, coarsest_elements=8,
                dtype="float32", cycle=cycle_spec(mg, RTOL_DIST_SMALL["solve"]))
            hier, fn = mg.build_halo_solver3d(cfg, pair, dev)
            r = fn(hier)
            gcfg = mg.models.poisson3d(
                finest_level=3, coarsest_level=0, coarsest_elements=8,
                dtype="float32", cycle=cycle_spec(mg, RTOL_DIST_SMALL["mgcg"]))
            _, gfn = mg.build_halo_mgcg3d(gcfg, pair, dev, hierarchy=hier)
            small[dev] = {"solve": dist_record(r),
                          "mgcg": dist_record(gfn(hier)),
                          "u": mg.gather_solution(hier, r.u, pair).cpu()}
        out["small"] = {"du": float((small["cuda"]["u"].double()
                                     - small["cpu"]["u"].double()).abs().max()),
                        **{dev: {k: small[dev][k] for k in ("solve", "mgcg")}
                           for dev in small}}
    dist.barrier()

    # phase 25: 512^3 f32 over all ranks, the main path
    u, out["main"] = dist_main(torch, dist, mg)
    torch.save(u.cpu(), Path(out_dir) / f"u_rank{rank}.pt")
    return out


def split_cycle_times(torch, dist, cfn, hier, u):
    """10 distributed V-cycles from u (cfn: a halo cycler of 10 cycles on
    every rank), timed plain and with the split instrumented (kernel
    time from CUDA events around every kernel wrapper call; halo and
    collective wall time around every SlabComm call, each after a device
    sync so that no kernel time lands in it), and one halo exchange of
    the finest block timed alone, 1- and 2-deep."""
    import time as _time

    from multigrid_dolfinx_tpu_torch.ops import dispatch
    from multigrid_dolfinx_tpu_torch.parallel.comm import SlabComm

    def ten():
        dist.barrier()
        torch.cuda.synchronize()
        s = _time.perf_counter()
        cfn(hier, u)
        torch.cuda.synchronize()
        return (_time.perf_counter() - s) * 1e3

    cfn(hier, u)
    plain_ms = ten()
    events, comm_s, comm_calls = [], [0.0], [0]
    kept = {}

    def kernel_timed(fn):
        def run(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            o = fn(*a, **k)
            e1.record()
            events.append((e0, e1))
            return o
        return run

    def comm_timed(fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            s = _time.perf_counter()
            o = fn(*a, **k)
            comm_s[0] += _time.perf_counter() - s
            comm_calls[0] += 1
            return o
        return run

    for name in dir(dispatch):
        obj = getattr(dispatch, name)
        if callable(obj) and getattr(obj, "__module__", "") == dispatch.__name__ \
                and not name.startswith("_") and name not in (
                    "const7_weights", "const5_ok", "require_const5"):
            kept[(dispatch, name)] = obj
            setattr(dispatch, name, kernel_timed(obj))
    for name in ("exchange", "gather_z", "sum_scalar"):
        kept[(SlabComm, name)] = getattr(SlabComm, name)
        setattr(SlabComm, name, comm_timed(getattr(SlabComm, name)))
    try:
        split_ms = ten()
    finally:
        for (obj, name), fn0 in kept.items():
            setattr(obj, name, fn0)
    kernel_ms = sum(a.elapsed_time(b) for a, b in events)
    comm = SlabComm()

    def exchange_ms(fn, reps=20):
        dist.barrier()
        torch.cuda.synchronize()
        s = _time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (_time.perf_counter() - s) * 1e3 / reps

    exchange = {"v 1-deep": exchange_ms(lambda: comm.halos(u, 1)),
                "v 2-deep": exchange_ms(lambda: comm.halos(u, 2))}
    return {"ms_per_vcycle": plain_ms / 10, "instrumented_ms": split_ms / 10,
            "kernel_ms": kernel_ms / 10, "comm_ms": comm_s[0] * 1e3 / 10,
            "comm_calls": comm_calls[0] // 10, "exchange_ms": exchange}


def dist_main(torch, dist, mg, finest_level=6):
    """The distributed 3D main path on this rank (every rank of the
    default group calls it, its card current): poisson3d(finest_level,
    coarsest_level=0, coarsest_elements=8) f32, FMG + V(2,2) red-black to
    rtol 1e-8, (G2) MG-CG from FMG and an FMG-started V(2,2) Jacobi solve
    to 1e-6 on the same hierarchy, with the launches of that run, then 10
    V-cycles timed (split_cycle_times).  Returns (this rank's slab of u,
    a picklable record)."""
    import time as _time

    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda

    cyc = cycle_spec(mg, 1e-8)
    cfg = mg.models.poisson3d(finest_level=finest_level, coarsest_level=0,
                              coarsest_elements=8, dtype="float32", cycle=cyc)
    jcyc = mg.CycleSpec(nu1=2, nu2=2, smoother="jacobi", restriction="pt",
                        tol=0.0, rtol=1e-6, max_cycles=40, track_error=False)
    jcfg = mg.models.poisson3d(finest_level=finest_level, coarsest_level=0,
                               coarsest_elements=8, dtype="float32",
                               cycle=jcyc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kcuda.reset_launch_counts()
    t0 = _time.perf_counter()
    hier, fn = mg.build_halo_solver3d(cfg)
    torch.cuda.synchronize()
    t1 = _time.perf_counter()
    res = fn(hier)
    torch.cuda.synchronize()
    t2 = _time.perf_counter()
    _, gfn = mg.build_halo_mgcg3d(cfg, hierarchy=hier)
    cg = gfn(hier)
    _, jfn = mg.build_halo_solver3d(jcfg, hierarchy=hier)
    jres = jfn(hier)
    torch.cuda.synchronize()
    counts = {k: n for k, n in kcuda.launch_counts().items() if n}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, cfn = mg.build_halo_cycler3d(cfg, 10, hierarchy=hier)
    split = split_cycle_times(torch, dist, cfn, hier, res.u)
    lm = hier.plan.lms[-1]
    zb = hier.z_base(hier.num_levels - 1)
    mid = lm // 2
    u_mid = (float(res.u[mid - zb, mid, mid])
             if zb <= mid < zb + res.u.shape[0] else None)
    return res.u, {
        "build_s": t1 - t0, "solve_s": t2 - t1, "solve": dist_record(res),
        "mgcg": dist_record(cg), "jacobi": dist_record(jres), "u_mid": u_mid,
        "counts": counts, "peak_gb": peak_gb, **split,
        "shard_from": hier.plan.shard_from,
        "mz": hier.plan.mz(hier.num_levels - 1)}


def same_run(np, a, b):
    """Two ranks' records of one run: the same count, flag and history
    bits (NaN where the history is NaN)."""
    return ((a["count"], a["converged"]) == (b["count"], b["converged"])
            and np.array_equal(a["hist"], b["hist"], equal_nan=True))


def phase_dist(torch, np, mg, card, main, out_dir):
    """Phases 24 and 25 in one spawn of DIST_RANKS ranks on the card over
    gloo (the library is built: phase 2)."""
    import shutil

    slabs = out_dir / "halo3d_slabs"
    slabs.mkdir(parents=True, exist_ok=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = mg.run_ranks(dist_rank, DIST_RANKS, "gloo", "cuda",
                             args=(str(slabs),), timeout=DIST_TIMEOUT_S)
        wall = time.perf_counter() - t0
        u_p = torch.cat([torch.load(slabs / f"u_rank{r}.pt")
                         for r in range(DIST_RANKS)])
    finally:
        shutil.rmtree(slabs, ignore_errors=True)

    # phase 24
    small = ranks[0]["small"]
    if not all(same_run(np, ranks[1]["small"][dev][kind], small[dev][kind])
               for dev in ("cuda", "cpu") for kind in ("solve", "mgcg")):
        raise AssertionError("ranks 0 and 1 disagree on the 64^3 run")
    for kind in ("solve", "mgcg"):
        g, c = small["cuda"][kind], small["cpu"][kind]
        hg, hc = np.array(g["hist"]), np.array(c["hist"])
        ok = (g["count"] == c["count"] and g["converged"] and c["converged"]
              and np.all(np.abs(hg - hc) <= 1e-5 * np.abs(hc)))
        print(f"phase 24 64^3 f32 P=2 {kind}: card {g['count']}, cpu "
              f"{c['count']} (converged {g['converged']}/{c['converged']}); "
              f"res_hist card {hg.tolist()} cpu {hc.tolist()}")
        if not ok:
            raise AssertionError(f"64^3 distributed {kind}: card and CPU "
                                 "differ")
    print(f"phase 24 max|u_card-u_cpu| {small['du']:.3e}")

    # phase 25
    runs = [r["main"] for r in ranks]
    m = runs[0]
    for other in runs[1:]:
        for key in ("solve", "mgcg", "jacobi"):
            if not same_run(np, other[key], m[key]):
                raise AssertionError(f"ranks disagree on the {key} run")
    lm = TIMED_LM
    u_p = u_p[:lm]
    u_mid = next(r["u_mid"] for r in runs if r["u_mid"] is not None)
    du = float((u_p - KEPT["u_main"]).abs().max())
    counts = {k: sum(r["counts"].get(k, 0) for r in runs)
              for k in set().union(*(r["counts"] for r in runs))}
    print(f"phase 25 512^3 f32 over {DIST_RANKS} ranks (gloo, one card, "
          f"shard_from {m['shard_from']}, {m['mz']} finest slabs a rank): "
          f"build {max(r['build_s'] for r in runs):.3f} s, solve "
          f"{max(r['solve_s'] for r in runs):.3f} s, {m['solve']['count']} "
          f"cycles after FMG (single-device {main['cycles']}), res_hist "
          f"{m['solve']['hist']}, u(1/2,1/2,1/2)={u_mid!r}, "
          f"max|u_P-u_1| {du!r}; (G2) MG-CG {m['mgcg']['count']} iterations "
          f"(converged {m['mgcg']['converged']}); Jacobi V(2,2) to 1e-6 "
          f"{m['jacobi']['count']} cycles (converged "
          f"{m['jacobi']['converged']}); spawn + run {wall:.1f} s")
    print("phase 25 per rank: " + "; ".join(
        f"rank {i}: peak {r['peak_gb']:.2f} GB, launches "
        f"{ {k: r['counts'].get(k, 0) for k in KERNELS_DIST} }"
        for i, r in enumerate(runs)))
    print("phase 25 V-cycle: " + "; ".join(
        f"rank {i}: {r['ms_per_vcycle']:.4f} ms (instrumented "
        f"{r['instrumented_ms']:.4f}: kernels {r['kernel_ms']:.4f}, halo and "
        f"collectives {r['comm_ms']:.4f} in {r['comm_calls']} calls)"
        for i, r in enumerate(runs)) + f" on [{card}]")
    print("phase 25 one exchange alone on the finest slab (ms): " + "; ".join(
        f"rank {i}: " + ", ".join(f"{k} {t:.4f}"
                                  for k, t in r["exchange_ms"].items())
        for i, r in enumerate(runs)))
    if not m["solve"]["converged"] or m["solve"]["count"] != main["cycles"]:
        raise AssertionError("the distributed 512^3 solve did not take the "
                             "single-device count")
    if not abs(u_mid - 2.5) < 1e-2:
        raise AssertionError(f"u(1/2,1/2,1/2) = {u_mid} is not 2.5 +- 1e-2")
    if du != 0.0:
        raise AssertionError(f"max|u_P - u_1| = {du} (0 expected)")
    if not m["mgcg"]["converged"] or not m["jacobi"]["converged"]:
        raise AssertionError("the distributed MG-CG or Jacobi run did not "
                             "converge")
    missing = [k for k in KERNELS_DIST if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"distributed path did not launch {missing}")
    return counts, {"small": small, "ranks": runs, "u_mid": u_mid,
                    "max_abs_du": du, "wall_s": wall}


def dist2d_rows(mg, lm, P):
    """The padded rows that parallel.halo's plan gives the lm^2 level over
    P ranks: those of (D2)'s 8193^2 hierarchy where the level is sharded
    there, else those of the hierarchy whose finest level it is."""
    from multigrid_dolfinx_tpu_torch.parallel.halo3d import ZPlan

    for lm_f in (TIMED_LM_2D, lm):
        fl = (lm_f - 1).bit_length() - 4      # 8 * 2^fl elements per axis
        plan = ZPlan.of(mg.models.poisson2d(
            finest_level=fl, coarsest_level=0, coarsest_elements=8), P)
        z = plan.zs[plan.lms.index(lm)]
        if z is not None:
            return z
    raise AssertionError(f"no plan shards lm={lm} over {P} ranks")


def dist2d_cases(sd, blk, lm, w, rb):
    """(name, kernel call, plain call) of K30-K34 on one rank's strip."""
    (v, vlo2, vhi2), (f, flo2, fhi2), (_, vlo1, vhi1), (df, _, _), \
        (c, _, chi) = blk
    lmc = (lm + 1) // 2
    a2 = (v, f, vlo2, vhi2, flo2, fhi2)
    return [
        ("rb_sweep_dist_2d", lambda: sd.rb_sweep_dist_2d(*a2, lm, rb),
         lambda: sd.rb_sweep_dist_2d_ref(*a2, lm, rb)),
        ("jacobi_sweep_dist_2d",
         lambda: sd.jacobi_sweep_dist_2d(v, df, vlo1, vhi1, lm, w, rb),
         lambda: sd.jacobi_sweep_dist_2d_ref(v, df, vlo1, vhi1, lm, w, rb)),
        ("residual_dist_2d",
         lambda: sd.residual_dist_2d(v, f, vlo1, vhi1, lm, rb),
         lambda: sd.residual_dist_2d_ref(v, f, vlo1, vhi1, lm, rb)),
        ("restrict_pt_dist_2d",
         lambda: sd.restrict_pt_dist_2d(v, vlo1, lm, lmc, rb),
         lambda: sd.restrict_pt_dist_2d_ref(v, vlo1, lm, lmc, rb)),
        ("prolong_add_dist_2d",
         lambda: sd.prolong_add_dist_2d(c, chi[:1], lm, rb, v),
         lambda: sd.prolong_add_dist_2d_ref(c, chi[:1], lm, rb, v)),
    ]


def phase_dist2d_kernels(torch, np, mg, records):
    """K30-K34 against their plain versions on every rank's strip (edge
    and interior ranks, P in {2, 4}) in f32 and f64 at lm in DIST2D_LMS,
    split as the plan splits them (dist2d_rows; 65^2 over 4 leaves rank 3
    all padding), bitwise; stitched over the ranks, bitwise the
    single-device K6, K5, K7, K8 and v + K9 on the same global data (plan
    padding rows 0); kernel, plain and bound times at a rank's finest
    strip of (D2) in f32, and the library call's where there is one (K33:
    a stride-2 conv2d, TF32 off; K34: F.interpolate plus the add)."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil2d as s2
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil2d_dist as sd

    rng = np.random.default_rng(SEED + 26)
    dev = torch.device("cuda")
    w = 2.0 / 3.0
    err = {}
    kcuda.reset_launch_counts()
    for dtype in (torch.float32, torch.float64):
        for lm in DIST2D_LMS:
            lmc = (lm + 1) // 2
            v, f = (torch.from_numpy(rng.standard_normal((lm, lm))).to(
                dev, dtype) for _ in range(2))
            c = torch.from_numpy(rng.standard_normal((lmc, lmc))).to(
                dev, dtype)
            df = torch.where(sd.strip_interior(lm, lm, 0, dev), f * 0.25, f)
            single = {
                "rb_sweep_dist_2d": s2.rb_sweep(v, f, lm),
                "jacobi_sweep_dist_2d": s2.jacobi_sweep(v, df, lm, w),
                "residual_dist_2d": s2.residual(v, f, lm),
                "restrict_pt_dist_2d": s2.restrict_pt(v, lm, lmc),
                "prolong_add_dist_2d": v + s2.prolong_linear(c, lm),
            }
            parts = []
            for P in (2, 4):
                z = dist2d_rows(mg, lm, P)
                blocks = list(zip(
                    dist_blocks(torch, v, P, z, 2),
                    dist_blocks(torch, f, P, z, 2),
                    dist_blocks(torch, v, P, z, 1),
                    dist_blocks(torch, df, P, z, 1),
                    dist_blocks(torch, c, P, z // 2, 1)))
                outs = {k: [] for k in KERNELS_DIST2D}
                for r in range(P):
                    for name, kern, plain in dist2d_cases(
                            sd, blocks[r], lm, w, r * (z // P)):
                        out, ref = kern(), plain()
                        check_close(name, out, ref, 0.0, err, [],
                                    f"lm={lm} P={P} rank={r} {dtype}")
                        outs[name].append(out)
                for name in KERNELS_DIST2D:
                    got = torch.cat(outs[name])
                    want = single[name]
                    n = want.shape[0]
                    if not (torch.equal(got[:n], want)
                            and not got[n:].any()):
                        raise AssertionError(
                            f"{name} stitched over {P} ranks at lm={lm} "
                            f"{dtype} is not the single-device kernel")
                parts.append(f"P={P} ({P} x ({z // P}, {lm})): 5 kernels "
                             "bitwise, stitched == single-device")
            print(f"phase 26 lm={lm} {str(dtype)[6:]}: " + "; ".join(parts))
            del v, f, c, df, single, blocks, outs
            torch.cuda.empty_cache()
    counts = kcuda.launch_counts()
    missing = [k for k in KERNELS_DIST2D if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"launch counters did not move: {missing}")

    # an interior rank's finest strip of (D2): row_base = m
    lm = TIMED_LM_2D
    lmc = (lm + 1) // 2
    m = dist2d_rows(mg, lm, DIST_RANKS) // DIST_RANKS

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    v, f, df = rand(m, lm), rand(m, lm), rand(m, lm)
    blk = ((v, rand(2, lm), rand(2, lm)), (f, rand(2, lm), rand(2, lm)))
    blk += ((v, blk[0][1][1:].contiguous(), blk[0][2][:1].contiguous()),
            (df, None, None), (rand(m // 2, lmc), None, rand(1, lmc)))
    pairs = {name: (kern, plain) for name, kern, plain in
             dist2d_cases(sd, blk, lm, w, m)}
    n, nc = m * lm, (m // 2) * lmc
    shape = {k: (n, nc if k in ("restrict_pt_dist_2d", "prolong_add_dist_2d")
                 else 0) for k in pairs}
    F = torch.nn.functional
    c = blk[4][0]
    w121 = torch.tensor([1.0, 2.0, 1.0], device=dev)
    kern_pt = (0.25 * torch.outer(w121, w121))[None, None]
    library = {
        "restrict_pt_dist_2d": no_tf32(torch, lambda: F.conv2d(
            v[None, None], kern_pt, stride=2, padding=1)),
        "prolong_add_dist_2d": lambda: v + F.interpolate(
            c[None, None], size=(m, lm), mode="bilinear",
            align_corners=True)[0, 0],
    }
    time_pairs(torch, pairs, err, records,
               f"phase 26 time at ({m}, {lm}) f32", shape, library)
    del v, f, df, blk, pairs, c
    torch.cuda.empty_cache()


def dist2d_rank(rank, world_size, device, out_dir):
    """One rank of phases 27 and 28 (run_ranks, gloo, every rank on the
    card): the 2049^2 distributed solves on ranks 0-1 on the card and on
    the CPU and the reference's run on the card, then (D2) on all
    ranks."""
    import torch
    import torch.distributed as dist

    import multigrid_dolfinx_tpu_torch as mg

    torch.set_num_threads(2)
    out = {}

    # phase 27: 2049^2 f32 over ranks 0-1, card and CPU; the reference run
    pair = dist.new_group([0, 1])
    if rank < 2:
        small = {}
        for dev in ("cuda", "cpu"):
            hier, runs = None, {}
            for smoother in ("rbgs", "jacobi"):
                cfg = mg.models.poisson2d(
                    finest_level=8, coarsest_level=0, coarsest_elements=8,
                    dtype="float32", cycle=cycle_spec(mg, RTOL_2D, smoother))
                hier, fn = mg.build_halo_solver(cfg, pair, dev, hier)
                r = fn(hier)
                runs[smoother] = dist_record(r)
                runs[smoother + " u"] = mg.gather_solution(hier, r.u,
                                                           pair).cpu()
            small[dev] = runs
        ref = mg.models.poisson2d()
        hier, fn = mg.build_halo_solver(ref, pair, "cuda")
        out["small"] = {
            "du": {k: float((small["cuda"][k + " u"].double()
                             - small["cpu"][k + " u"].double()).abs().max())
                   for k in ("rbgs", "jacobi")},
            "reference": dist_record(fn(hier)),
            **{dev: {k: small[dev][k] for k in ("rbgs", "jacobi")}
               for dev in small}}
    # first CUDA use on ranks 2-3 (module loads), outside phase 28's timed
    # build
    mg.build_lean_hierarchy(mg.models.poisson2d(
        finest_level=1, coarsest_level=0, dtype="float32"))
    dist.barrier()

    # phase 28: (D2), 8193^2 f32 over all ranks
    u, ju, out["main"] = dist2d_main(torch, dist, mg)
    torch.save(u.cpu(), Path(out_dir) / f"u_rank{rank}.pt")
    torch.save(ju.cpu(), Path(out_dir) / f"ju_rank{rank}.pt")
    return out


def dist2d_main(torch, dist, mg):
    """(D2) on this rank (every rank of the default group calls it, its
    card current): poisson2d(FINEST_LEVEL_2D, coarsest_level=0,
    coarsest_elements=8) f32, FMG + V(2,2) red-black to RTOL_2D and an
    FMG-started V(2,2) Jacobi solve to RTOL_2D on the same hierarchy,
    with the launches of that run, then 10 V-cycles timed
    (split_cycle_times).  Returns (this rank's strip of u, of the Jacobi
    u, a picklable record)."""
    import time as _time

    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda

    cfg, jcfg = (mg.models.poisson2d(
        finest_level=FINEST_LEVEL_2D, coarsest_level=0, coarsest_elements=8,
        dtype="float32", cycle=cycle_spec(mg, RTOL_2D, sm))
        for sm in ("rbgs", "jacobi"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kcuda.reset_launch_counts()
    t0 = _time.perf_counter()
    hier, fn = mg.build_halo_solver(cfg)
    torch.cuda.synchronize()
    t1 = _time.perf_counter()
    res = fn(hier)
    torch.cuda.synchronize()
    t2 = _time.perf_counter()
    _, jfn = mg.build_halo_solver(jcfg, hierarchy=hier)
    jres = jfn(hier)
    torch.cuda.synchronize()
    counts = {k: n for k, n in kcuda.launch_counts().items() if n}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, cfn = mg.build_halo_cycler(cfg, 10, hierarchy=hier)
    split = split_cycle_times(torch, dist, cfn, hier, res.u)
    lm = hier.plan.lms[-1]
    rb = hier.z_base(hier.num_levels - 1)
    mid = lm // 2
    u_mid = (float(res.u[mid - rb, mid])
             if rb <= mid < rb + res.u.shape[0] else None)
    return res.u, jres.u, {
        "build_s": t1 - t0, "solve_s": t2 - t1, "solve": dist_record(res),
        "jacobi": dist_record(jres), "u_mid": u_mid, "counts": counts,
        "peak_gb": peak_gb, **split, "shard_from": hier.plan.shard_from,
        "rows": hier.plan.mz(hier.num_levels - 1)}


def phase_dist2d(torch, np, mg, card, main_2d, out_dir):
    """Phases 27 and 28 in one spawn of DIST_RANKS ranks on the card over
    gloo (the library is built: phase 2), beside the single-device
    Jacobi solve of (D2) in this process."""
    import shutil

    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda

    # the single-device Jacobi solve of (D2), for phase 28
    torch.cuda.empty_cache()
    jcfg = mg.models.poisson2d(
        finest_level=FINEST_LEVEL_2D, coarsest_level=0, coarsest_elements=8,
        dtype="float32", cycle=cycle_spec(mg, RTOL_2D, "jacobi"))
    j1 = mg.solve(mg.build_lean_hierarchy(jcfg), jcfg.cycle)
    j1_u, j1_count = j1.u.cpu(), j1.num_cycles
    del j1
    torch.cuda.empty_cache()

    strips = out_dir / "halo2d_strips"
    strips.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        ranks = mg.run_ranks(dist2d_rank, DIST_RANKS, "gloo", "cuda",
                             args=(str(strips),), timeout=DIST_TIMEOUT_S)
        wall = time.perf_counter() - t0
        u_p, ju_p = (torch.cat([torch.load(strips / f"{k}_rank{r}.pt")
                                for r in range(DIST_RANKS)])
                     for k in ("u", "ju"))
    finally:
        shutil.rmtree(strips, ignore_errors=True)

    # phase 27
    small = ranks[0]["small"]
    if not all(same_run(np, ranks[1]["small"][dev][kind], small[dev][kind])
               for dev in ("cuda", "cpu") for kind in ("rbgs", "jacobi")):
        raise AssertionError("ranks 0 and 1 disagree on the 2049^2 run")
    if not same_run(np, ranks[1]["small"]["reference"], small["reference"]):
        raise AssertionError("ranks 0 and 1 disagree on the reference run")
    for kind in ("rbgs", "jacobi"):
        g, c = small["cuda"][kind], small["cpu"][kind]
        hg, hc = np.array(g["hist"]), np.array(c["hist"])
        print(f"phase 27 2049^2 f32 P=2 {kind}: card {g['count']}, cpu "
              f"{c['count']} (converged {g['converged']}/{c['converged']}); "
              f"res_hist card {hg.tolist()} cpu {hc.tolist()}; "
              f"max|u_card-u_cpu| {small['du'][kind]!r}")
        if not (g["count"] == c["count"] and g["converged"]
                and c["converged"]
                and np.all(np.abs(hg - hc) <= 1e-5 * np.abs(hc))):
            raise AssertionError(f"2049^2 distributed {kind}: card and CPU "
                                 "differ")
        if small["du"][kind] != 0.0:
            raise AssertionError(f"2049^2 distributed {kind}: u on the card "
                                 "is not the CPU's")
    ref = small["reference"]
    print(f"phase 27 reference run (65^2 f64, V(50,50) Jacobi, injection) "
          f"over 2 ranks on the card: {ref['count']} cycles (converged "
          f"{ref['converged']}), final residual {ref['hist'][-1]!r}")
    if ref["count"] != 63 or not ref["converged"]:
        raise AssertionError(f"the distributed reference run took "
                             f"{ref['count']} cycles, not 63")

    # phase 28
    runs = [r["main"] for r in ranks]
    m = runs[0]
    for other in runs[1:]:
        for key in ("solve", "jacobi"):
            if not same_run(np, other[key], m[key]):
                raise AssertionError(f"ranks disagree on the (D2) {key} run")
    lm = TIMED_LM_2D
    u_p, ju_p = u_p[:lm], ju_p[:lm]
    u_mid = next(r["u_mid"] for r in runs if r["u_mid"] is not None)
    du = float((u_p - KEPT["u_2d"]).abs().max())
    dju = float((ju_p - j1_u).abs().max())
    counts = {k: sum(r["counts"].get(k, 0) for r in runs)
              for k in set().union(*(r["counts"] for r in runs))}
    print(f"phase 28 8193^2 f32 over {DIST_RANKS} ranks (gloo, one card, "
          f"shard_from {m['shard_from']}, {m['rows']} finest rows a rank): "
          f"build {max(r['build_s'] for r in runs):.3f} s, solve "
          f"{max(r['solve_s'] for r in runs):.3f} s, {m['solve']['count']} "
          f"cycles after FMG (single-device {main_2d['cycles']}), res_hist "
          f"{m['solve']['hist']}, u(1/2,1/2)={u_mid!r}, max|u_P-u_1| {du!r}; "
          f"Jacobi V(2,2) to {RTOL_2D} {m['jacobi']['count']} cycles "
          f"(single-device {j1_count}), max|u_P-u_1| {dju!r}; spawn + run "
          f"{wall:.1f} s")
    print("phase 28 per rank: " + "; ".join(
        f"rank {i}: build {r['build_s']:.3f} s, peak {r['peak_gb']:.2f} GB, "
        f"launches { {k: r['counts'].get(k, 0) for k in KERNELS_DIST2D} }"
        for i, r in enumerate(runs)))
    print("phase 28 V-cycle: " + "; ".join(
        f"rank {i}: {r['ms_per_vcycle']:.4f} ms (instrumented "
        f"{r['instrumented_ms']:.4f}: kernels {r['kernel_ms']:.4f}, halo and "
        f"collectives {r['comm_ms']:.4f} in {r['comm_calls']} calls)"
        for i, r in enumerate(runs)) + f" on [{card}]")
    print("phase 28 one exchange alone on the finest strip (ms): " + "; ".join(
        f"rank {i}: " + ", ".join(f"{k} {t:.4f}"
                                  for k, t in r["exchange_ms"].items())
        for i, r in enumerate(runs)))
    if not m["solve"]["converged"] or m["solve"]["count"] != main_2d["cycles"]:
        raise AssertionError("the distributed 8193^2 solve did not take the "
                             "single-device count")
    if du != 0.0:
        raise AssertionError(f"max|u_P - u_1| = {du} (0 expected)")
    if not m["jacobi"]["converged"] or m["jacobi"]["count"] != j1_count \
            or dju != 0.0:
        raise AssertionError("the distributed Jacobi run is not the "
                             "single-device one")
    missing = [k for k in KERNELS_DIST2D
               if not all(r["counts"].get(k, 0) for r in runs)]
    if missing:
        raise AssertionError(f"a rank of (D2) did not launch {missing}")
    return counts, {"small": small, "ranks": runs, "u_mid": u_mid,
                    "max_abs_du": du, "jacobi_max_abs_du": dju,
                    "jacobi_single_device": j1_count, "wall_s": wall}


def cycle_kernel_cases(s3, sc, v, f, c, lm, lmc, wc, woff):
    """(name, kernel outputs, plain outputs, unfused CUDA chain outputs)
    of the half sweep and K35-K37 on one input set."""
    k1 = s3.rb_sweep(v, f, lm, wc, woff)
    halves = tuple(s3.rb_half_sweep(v, f, lm, wc, woff, k) for k in (0, 1))
    return [
        ("rb_half_sweep",
         halves + (s3.rb_half_sweep(halves[0], f, lm, wc, woff, 1),),
         tuple(s3.rb_half_sweep_ref(v, f, lm, wc, woff, k) for k in (0, 1))
         + (s3.rb_sweep_ref(v, f, lm, wc, woff),),
         (None, None, k1)),
        ("rb_sweep2", (sc.rb_sweep2(v, f, lm, wc, woff),),
         (sc.rb_sweep2_ref(v, f, lm, wc, woff),),
         (s3.rb_sweep(k1, f, lm, wc, woff),)),
        ("rb_residual_restrict",
         sc.rb_residual_restrict(v, f, lm, lmc, wc, woff),
         sc.rb_residual_restrict_ref(v, f, lm, lmc, wc, woff),
         (k1, s3.restrict_residual_pt(k1, f, lm, lmc, wc, woff))),
        ("prolong_correct_rb", (sc.prolong_correct_rb(c, v, f, lm, wc, woff),),
         (sc.prolong_correct_rb_ref(c, v, f, lm, wc, woff),),
         (s3.rb_sweep(s3.prolong_linear(c, lm, v), f, lm, wc, woff),)),
    ]


def phase_cycle_kernels(torch, np, mg, records):
    """The half sweep and K35-K37 against their plain versions and against
    the unfused CUDA chains they replace (two half sweeps = K1; K1 twice;
    K1 then K2; K3 then K1), bitwise, in f32 and f64 at lm in KERNEL_LMS;
    then kernel, plain and unfused-chain times at 513^3 f32 (CUDA events,
    the least of 2 x 10)."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d as s3
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_cycle as sc

    rng = np.random.default_rng(SEED + 29)
    dev = torch.device("cuda")
    err = {k: 0.0 for k in KERNELS_CYCLE}
    kcuda.reset_launch_counts()
    for dtype in (torch.float32, torch.float64):
        for lm in KERNEL_LMS:
            lmc = (lm + 1) // 2
            wc, woff = level_weights(mg, lm)
            v, f, c = (torch.from_numpy(rng.standard_normal((n,) * 3)).to(
                dev, dtype) for n in (lm, lm, lmc))
            cases = cycle_kernel_cases(s3, sc, v, f, c, lm, lmc, wc, woff)
            torch.cuda.synchronize()
            parts, where = [], f"lm={lm} {str(dtype)[6:]}"
            for name, outs, refs, chain in cases:
                for out, ref in zip(outs, refs):
                    check_close(name, out, ref, 0.0, err, parts, where)
                for out, ref in zip(outs, chain):
                    if ref is not None and not torch.equal(out, ref):
                        raise AssertionError(f"{name} at {where} is not its "
                                             "unfused CUDA chain bitwise")
            print(f"phase 29 {where}: max|kernel-plain| " + " ".join(parts)
                  + "; each equal to its unfused CUDA chain")
            del v, f, c, cases
    counts = kcuda.launch_counts()
    missing = [k for k in KERNELS_CYCLE if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"launch counters did not move: {missing}")
    torch.cuda.empty_cache()

    lm, lmc = TIMED_LM, (TIMED_LM + 1) // 2
    wc, woff = level_weights(mg, lm)
    v, f, c = (torch.from_numpy(rng.standard_normal((n,) * 3).astype(
        np.float32)).to(dev) for n in (lm, lm, lmc))
    runs = {
        "rb_half_sweep": (
            lambda: s3.rb_half_sweep(v, f, lm, wc, woff, 0),
            lambda: s3.rb_half_sweep_ref(v, f, lm, wc, woff, 0), None),
        "rb_sweep2": (
            lambda: sc.rb_sweep2(v, f, lm, wc, woff),
            lambda: sc.rb_sweep2_ref(v, f, lm, wc, woff),
            lambda: s3.rb_sweep(s3.rb_sweep(v, f, lm, wc, woff), f, lm, wc,
                                woff)),
        "rb_residual_restrict": (
            lambda: sc.rb_residual_restrict(v, f, lm, lmc, wc, woff),
            lambda: sc.rb_residual_restrict_ref(v, f, lm, lmc, wc, woff),
            lambda: s3.restrict_residual_pt(s3.rb_sweep(v, f, lm, wc, woff),
                                            f, lm, lmc, wc, woff)),
        "prolong_correct_rb": (
            lambda: sc.prolong_correct_rb(c, v, f, lm, wc, woff),
            lambda: sc.prolong_correct_rb_ref(c, v, f, lm, wc, woff),
            lambda: s3.rb_sweep(s3.prolong_linear(c, lm, v), f, lm, wc,
                                woff)),
    }
    chain_ms = {}
    for name, (kern, plain, chain) in runs.items():
        p1 = time_ms(torch, plain, reps=3, warmup=1)
        k1, k2 = time_ms(torch, kern), time_ms(torch, kern)
        p2 = time_ms(torch, plain, reps=3, warmup=1)
        ch = (min(time_ms(torch, chain), time_ms(torch, chain))
              if chain else None)
        bound_ms, bound_by = bound(name, lm ** 3, lmc ** 3)
        records[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": 0,
            "max_abs_err": err[name], "ms": min(k1, k2),
            "plain_ms": min(p1, p2), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        }
        chain_ms[name] = ch
        extra = "" if ch is None else f", unfused CUDA chain {ch:.4f} ms"
        print(f"phase 29 time at lm={lm} f32 {name}: kernel {k1:.4f}/"
              f"{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms{extra}, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
    del v, f, c
    torch.cuda.empty_cache()
    return {"unfused_chain_ms": chain_ms,
            "max_abs_err": {k: err[k] for k in KERNELS_CYCLE}}


def fused_launches_expected(cyc):
    """The fused kernels a V/W/F(nu1, nu2) solve with cyc.fusion must
    launch on the 512^3 hierarchy: K36 and K37 where named; K35 where
    named and a smoothing phase keeps a pair of sweeps after them."""
    fu = cyc.fusion
    left = max(cyc.nu1 - ("rb_restrict" in fu), cyc.nu2 - ("prolong_rb" in fu))
    return {"rb_sweep2": "rb2" in fu and left >= 2,
            "rb_residual_restrict": "rb_restrict" in fu,
            "prolong_correct_rb": "prolong_rb" in fu}


def fused_solve(torch, mg, hier, cyc, label):
    """One solve on the card with the launch counts set to 0 just before
    and read just after; raises unless exactly the expected fused
    kernels ran."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda

    torch.cuda.synchronize()
    kcuda.reset_launch_counts()
    t0 = time.perf_counter()
    res = mg.solve(hier, cyc)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kcuda.launch_counts()
    for name, want in fused_launches_expected(cyc).items():
        if bool(counts.get(name, 0)) != want:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{counts.get(name, 0)} times")
    return res, counts, secs


def phase_fusion(torch, np, mg, card, main):
    """(a) phase 5's configuration with each fusion set: phase 5's cycle
    count and u bitwise; V-cycle times beside the unfused one, in turns;
    (b) 64^3 f32, every fusion, the card's res_hist and u bitwise the
    plain path's on the CPU; (c) W(2,2) and F(2,2) at 512^3 f32 with
    every fusion: converged, u(1/2,1/2,1/2) within 1e-2 of 2.5, cycles
    and ms a cycle.  Returns the summed launch counts of (a) and (c)."""
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    cyc = cycle_spec(mg, 1e-8)
    cfg = mg.models.poisson3d(finest_level=6, coarsest_level=0,
                              coarsest_elements=8, dtype="float32", cycle=cyc)
    hier = mg.build_lean_hierarchy(cfg, device=torch.device("cuda"))
    lm = hier.finest.n + 1
    mid = lm // 2
    out = {"a": {}, "c": {}}
    specs = {fu: dataclasses.replace(cyc, fusion=fu) for fu in FUSION_SETS}
    for fu, spec in specs.items():
        res, counts, secs = fused_solve(torch, mg, hier, spec, f"(a) {fu}")
        add(counts)
        same = torch.equal(res.u.cpu(), KEPT["u_main"])
        print(f"phase 30 (a) 512^3 f32 fusion {fu}: {res.num_cycles} cycles "
              f"after FMG (phase 5: {main['cycles']}), u bitwise phase 5's: "
              f"{same}, solve {secs:.3f} s, launches "
              f"{ {k: counts.get(k, 0) for k in ('rb_sweep', 'rb_half_sweep') + KERNELS_CYCLE[1:]} }")
        if not (res.converged and res.num_cycles == main["cycles"] and same):
            raise AssertionError(f"fusion {fu}: not phase 5's solve")
        out["a"][" ".join(fu)] = {"cycles": res.num_cycles, "counts": counts,
                                  "solve_s": secs}
        u_last = res.u
    # ms a V-cycle: unfused, each set, each set again, unfused
    L = hier.num_levels - 1
    times = {}
    for fu in ((),) + FUSION_SETS + FUSION_SETS + ((),):
        spec = dataclasses.replace(cyc, fusion=fu)
        holder = [u_last.clone()]

        def one_cycle():
            holder[0] = mg.vcycle(hier, spec, L, holder[0], hier.finest.b)

        ms = time_ms(torch, one_cycle, reps=10, warmup=1)
        key = " ".join(fu) or "unfused"
        times[key] = min(times.get(key, ms), ms)
    print("phase 30 (a) ms/V-cycle at 512^3 f32 (least of two runs of 10, "
          f"in turns; phase 5 {main['ms_per_vcycle']:.4f}): " + ", ".join(
              f"{k} {t:.4f}" for k, t in times.items()) + f" on [{card}]")
    out["a_ms_per_vcycle"] = times

    # (b) 64^3, card against the plain path on the CPU
    small = dataclasses.replace(cycle_spec(mg, 1e-7), fusion=FUSION_SETS[-1])
    scfg = mg.models.poisson3d(finest_level=3, coarsest_level=0,
                               coarsest_elements=8, dtype="float32",
                               cycle=small)
    g = mg.solve(mg.build_lean_hierarchy(scfg, device="cuda"), small)
    c = mg.solve(mg.build_lean_hierarchy(scfg, device="cpu"),
                 dataclasses.replace(small, fusion=()))
    hg = g.res_hist[:g.num_cycles].cpu()
    same = (g.num_cycles == c.num_cycles and torch.equal(hg, c.res_hist[
        :c.num_cycles]) and torch.equal(g.u.cpu(), c.u))
    print(f"phase 30 (b) 64^3 f32 every fusion on the card vs the plain path "
          f"on the CPU: {g.num_cycles} / {c.num_cycles} cycles, res_hist "
          f"{hg.double().tolist()}, res_hist and u bitwise: {same}")
    if not (same and g.converged):
        raise AssertionError("64^3 fused card run differs from the CPU's")

    # (c) W and F cycles with every fusion
    for shape in ("W", "F"):
        spec = dataclasses.replace(cyc, cycle=shape, fusion=FUSION_SETS[-1])
        res, counts, secs = fused_solve(torch, mg, hier, spec,
                                        f"(c) {shape}")
        add(counts)
        u_mid = float(res.u[mid, mid, mid])
        holder = [res.u.clone()]

        def one_cycle():
            holder[0] = mg.vcycle(hier, spec, L, holder[0], hier.finest.b)

        ms = min(time_ms(torch, one_cycle, reps=5, warmup=1),
                 time_ms(torch, one_cycle, reps=5, warmup=1))
        print(f"phase 30 (c) 512^3 f32 {shape}(2,2) every fusion: "
              f"{res.num_cycles} cycles after FMG (converged "
              f"{res.converged}), res_hist "
              f"{res.res_hist[:res.num_cycles].double().tolist()}, "
              f"u(1/2,1/2,1/2)={u_mid!r}, solve {secs:.3f} s, {ms:.4f} ms a "
              f"cycle (least of two runs of 5) on [{card}]")
        if not (res.converged and abs(u_mid - 2.5) < 1e-2):
            raise AssertionError(f"{shape}-cycle 512^3 solve failed")
        out["c"][shape] = {"cycles": res.num_cycles, "u_mid": u_mid,
                           "ms_per_cycle": ms, "solve_s": secs,
                           "counts": counts}
    del hier, u_last
    torch.cuda.empty_cache()
    return total, out


def mass_tables(torch, mg, lm, diagonal, dtype, dev):
    """(offsets, tables) of the consistent P1 mass on an lm^3 level with
    this diagonal, scaled as build_lean_hierarchy scales them."""
    from multigrid_dolfinx_tpu_torch.fem.fast_const import mass_class_tables

    problem = dataclasses.replace(mg.models.poisson3d().problem,
                                  diagonal=diagonal)
    offs, tables = mass_class_tables(problem)
    return offs, torch.as_tensor(tables * (4.0 / (lm - 1)) ** 3, dtype=dtype,
                                 device=dev)


def generic_tables(torch, rng, dtype, dev):
    """A random class table on all 27 offsets, diagonally dominant (a
    well-conditioned r^T M r), its interior column symmetrised."""
    t = rng.uniform(0.0, 1.0, (27, 27))
    t[13] += 30.0
    t[:, 13] = 0.5 * (t[:, 13] + t[::-1, 13])    # BOX27[26 - k] = -BOX27[k]
    return BOX27, torch.as_tensor(t, dtype=dtype, device=dev)


def phase_mass_quad_kernel(torch, np, mg, records):
    """K38 against its plain version within TOL_NORM and two calls bitwise
    equal, in f32 and f64 at lm in KERNEL_LMS, on the P1 mass tables of
    both diagonals (there also against K4 within TOL_NORM) and, up to
    MASS_GENERIC_LM, a random 27-offset table; then kernel / plain times
    at 513^3 f32 beside K4's."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_norm as sn

    name = "residual_mass_quad"
    rng = np.random.default_rng(SEED + 31)
    dev = torch.device("cuda")
    err, err_k4 = {name: 0.0}, {name: 0.0}
    kcuda.reset_launch_counts()
    for dtype in (torch.float32, torch.float64):
        for lm in KERNEL_LMS:
            wc, woff = level_weights(mg, lm)
            v, f = (torch.from_numpy(rng.standard_normal((lm,) * 3)).to(
                dev, dtype) for _ in range(2))
            sets = [(d, *mass_tables(torch, mg, lm, d, dtype, dev))
                    for d in ("right", "left")]
            if lm <= MASS_GENERIC_LM:
                sets.append((None, *generic_tables(torch, rng, dtype, dev)))
            parts, where = [], f"lm={lm} {str(dtype)[6:]}"
            for diag, offs, tables in sets:
                q = sn.residual_mass_quad(v, f, tables, offs, lm, wc, woff)
                q2 = sn.residual_mass_quad(v, f, tables, offs, lm, wc, woff)
                ref = sn.residual_mass_quad_ref(v, f, tables, offs, lm, wc,
                                                woff)
                torch.cuda.synchronize()
                label = diag or "27-offset"
                check_close(name, q, ref, TOL_NORM, err, parts,
                            f"{where} {label}")
                if not torch.equal(q, q2):
                    raise AssertionError(f"{name} at {where} {label}: two "
                                         "calls differ")
                if diag is not None:
                    q4 = sn.residual_tet_quad(v, f, lm, wc, woff, diag)
                    check_close(name, q, q4, TOL_NORM, err_k4, parts,
                                f"{where} {label} against K4")
            print(f"phase 31 {where}: |K38-plain| and |K38-K4| (right, left; "
                  "then the 27-offset table's |K38-plain|) " + " ".join(parts)
                  + "; two calls bitwise equal")
            del v, f, sets
    if kcuda.launch_counts()[name] == 0:
        raise AssertionError(f"launch counter did not move: {name}")
    torch.cuda.empty_cache()

    lm = TIMED_LM
    wc, woff = level_weights(mg, lm)
    v, f = (torch.from_numpy(rng.standard_normal((lm,) * 3).astype(
        np.float32)).to(dev) for _ in range(2))
    offs, tables = mass_tables(torch, mg, lm, "right", torch.float32, dev)
    pairs = {name: (
        lambda: sn.residual_mass_quad(v, f, tables, offs, lm, wc, woff),
        lambda: sn.residual_mass_quad_ref(v, f, tables, offs, lm, wc, woff))}
    time_pairs(torch, pairs, err, records, f"phase 31 time at lm={lm} f32",
               {name: (lm ** 3, 0)})
    k4_ms = min(time_ms(torch, lambda: sn.residual_tet_quad(
        v, f, lm, wc, woff, "right")) for _ in range(2))
    print(f"phase 31 K4 residual_tet_quad at lm={lm} f32 on the same v, f: "
          f"{k4_ms:.4f} ms; K38 / K4 {records[name]['ms'] / k4_ms:.3f}")
    del v, f
    torch.cuda.empty_cache()
    return {"max_abs_err": err[name], "max_abs_err_vs_k4": err_k4[name],
            "k4_ms": k4_ms}


def phase_mass_quad_path(torch, np, mg, card, main):
    """Phase 5's configuration with the mass uncertified
    (uniform_p1_mass=None), the check on K38: phase 5's cycles, u bitwise,
    res_hist within TOL_NORM, K38 launched once a check and K4 never;
    the check's ms on both masses."""
    from multigrid_dolfinx_tpu_torch.ops import cuda as kcuda
    from multigrid_dolfinx_tpu_torch.solver.fmg import check_norm

    cyc = cycle_spec(mg, 1e-8)
    cfg = mg.models.poisson3d(finest_level=6, coarsest_level=0,
                              coarsest_elements=8, dtype="float32", cycle=cyc)
    certified = mg.build_lean_hierarchy(cfg, device=torch.device("cuda"))
    hier = dataclasses.replace(certified, M_fine=dataclasses.replace(
        certified.M_fine, uniform_p1_mass=None))
    torch.cuda.synchronize()
    kcuda.reset_launch_counts()
    t0 = time.perf_counter()
    res = mg.solve(hier, cyc)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kcuda.launch_counts()
    hist = res.res_hist[:res.num_cycles].double().cpu().numpy()
    ref = np.asarray(main["res_hist"])
    same = torch.equal(res.u.cpu(), KEPT["u_main"])
    rel = (float(np.max(np.abs(hist - ref) / np.abs(ref)))
           if len(hist) == len(ref) else math.inf)
    b = hier.finest.b
    check_ms = {k: min(time_ms(torch, lambda: check_norm(h, res.u, b))
                       for _ in range(2))
                for k, h in (("K38", hier), ("K4", certified))}
    launches = {k: counts.get(k, 0)
                for k in ("residual_mass_quad", "residual_tet_quad")}
    print(f"phase 32 512^3 f32 uncertified mass: {res.num_cycles} cycles "
          f"after FMG (phase 5: {main['cycles']}), converged={res.converged}, "
          f"res_hist {hist.tolist()} (phase 5 {ref.tolist()}, max rel diff "
          f"{rel:.3e}), u bitwise phase 5's: {same}, solve {secs:.3f} s, "
          f"launches {launches}; the check {check_ms['K38']:.4f} ms on K38, "
          f"{check_ms['K4']:.4f} ms on K4 (certified) on [{card}]")
    if not (res.converged and res.num_cycles == main["cycles"] and same):
        raise AssertionError("uncertified mass: not phase 5's solve")
    if not rel <= TOL_NORM:
        raise AssertionError(f"uncertified mass: res_hist off by {rel:.3e}")
    if launches != {"residual_mass_quad": res.num_cycles + 1,
                    "residual_tet_quad": 0}:
        raise AssertionError(f"uncertified mass: check launches {launches}")
    del hier, certified, res
    torch.cuda.empty_cache()
    return counts, {"cycles": len(hist), "res_hist": hist.tolist(),
                    "solve_s": secs, "check_ms": check_ms,
                    "launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "chip_smoke",
                    help="directory for nvcc's report and chip_smoke.json")
    out_dir = ap.parse_args().out
    try:
        import torch
    except ImportError as exc:
        print(f"FAILED: torch unavailable ({exc})")
        return 1
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is false; this check needs "
              "a CUDA card")
        return 1
    phase = "import"
    marks = []              # (phase, start time) for the per-phase seconds

    def enter(name):
        marks.append((name, time.perf_counter()))
        return name

    try:
        import numpy as np

        import multigrid_dolfinx_tpu_torch as mg
        from multigrid_dolfinx_tpu_torch.ops.cuda import build

        if "jax" in sys.modules:
            raise AssertionError("jax was imported")
        phase = enter("1 device")
        name, card = phase_device(torch)
        phase = enter("2 build")
        out_dir.mkdir(parents=True, exist_ok=True)
        build_s = phase_build(build, out_dir)
        records = {}
        phase = enter("3 kernels")
        phase_kernels(torch, np, mg, records)
        phase = enter("4 slice 64^3")
        phase_small_slice(torch, np, mg)
        phase = enter("5 main path 512^3")
        counts, main = phase_main(torch, np, mg, card)
        phase = enter("6 kernels 2D")
        phase_kernels_2d(torch, np, records)
        phase = enter("7 reference run")
        counts_ref, reference = phase_reference(torch, np, mg)
        phase = enter("8 2D 2049^2")
        phase_2d_small(torch, np, mg)
        phase = enter("9 2D main path 8193^2")
        counts_2d, main_2d = phase_main_2d(torch, np, mg, card)
        phase = enter("10 kernels K10-K12")
        phase_kernels_slice3(torch, np, mg, records)
        phase = enter("11 slice 3 at 64^3")
        phase_small_slice3(torch, np, mg)
        phase = enter("12 BASELINE configs 3 and 5 at 512^3")
        counts_s3, slice3 = phase_slice3(torch, np, mg, card)
        phase = enter("13 fused coarse tail")
        tail = phase_tail(torch, np, mg, records)
        phase = enter("14 kernels K15-K18")
        planes = phase_planes_kernels(torch, np, mg, records)
        phase = enter("15 var kappa at 64^3")
        small_var = phase_small_var(torch, np, mg)
        phase = enter("16 var kappa at 384^3")
        counts_var, var = phase_var(torch, np, mg, card, records)
        phase = enter("17 kernels K19-K21")
        p2_kernels = phase_p2_kernels(torch, np, mg, records)
        phase = enter("18 P2 at the 65^3 lattice")
        small_p2 = phase_small_p2(torch, np, mg)
        phase = enter("19 P2 at the 513^3 lattice")
        counts_p2, p2 = phase_p2(torch, np, mg, card)
        phase = enter("20 kernels K22-K24")
        planes2 = phase_planes2_kernels(torch, np, mg, records)
        phase = enter("21 2D var kappa at 2049^2")
        small_var2d = phase_small_var2d(torch, np, mg)
        phase = enter("22 2D var kappa at 8193^2")
        counts_var2d, var2d = phase_var2d(torch, np, mg, card, records)
        phase = enter("23 kernels K25-K29")
        dist_kernels = phase_dist_kernels(torch, np, mg, records)
        phase = enter("24-25 distributed 3D")
        counts_dist, dist3d = phase_dist(torch, np, mg, card, main, out_dir)
        phase = enter("26 kernels K30-K34")
        phase_dist2d_kernels(torch, np, mg, records)
        phase = enter("27-28 distributed 2D")
        counts_dist2d, dist2d = phase_dist2d(torch, np, mg, card, main_2d,
                                             out_dir)
        phase = enter("29 kernels K35-K37 and the half sweep")
        cycle_kernels = phase_cycle_kernels(torch, np, mg, records)
        phase = enter("30 fused and W/F cycles at 512^3")
        counts_fusion, fusion = phase_fusion(torch, np, mg, card, main)
        phase = enter("31 kernel K38")
        mass_quad = phase_mass_quad_kernel(torch, np, mg, records)
        phase = enter("32 uncertified mass at 512^3")
        counts_mq, mass_quad_path = phase_mass_quad_path(torch, np, mg, card,
                                                         main)
    except Exception:
        print(f"FAILED in phase {phase}:")
        traceback.print_exc(file=sys.stdout)
        return 1
    marks.append(("end", time.perf_counter()))
    phase_s = {a[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])}
    print(f"phase seconds: {json.dumps(phase_s)}")
    # launches: each kernel's count in the main path that runs it
    for k, rec in records.items():
        rec["launches"] = (counts[k] if k in KERNELS_3D + KERNELS_TAIL else
                           counts_ref[k] if k == "jacobi_sweep_2d" else
                           counts_s3[k] if k in KERNELS_SLICE3 else
                           counts_var[k] if k in KERNELS_PLANES else
                           counts_p2[k] if k in KERNELS_P2 else
                           counts_var2d[k] if k in KERNELS_PLANES2 else
                           counts_dist[k] if k in KERNELS_DIST else
                           counts_dist2d[k] if k in KERNELS_DIST2D else
                           counts_fusion[k] if k in KERNELS_CYCLE else
                           counts_mq[k] if k == "residual_mass_quad" else
                           counts_2d[k])
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "main": main,
         "reference": reference, "main_2d": main_2d, "slice3": slice3,
         "tail": tail, "planes": planes, "var_64": small_var, "var": var,
         "p2_kernels": p2_kernels, "p2_65": small_p2, "p2": p2,
         "planes2": planes2, "var2d_2049": small_var2d, "var2d": var2d,
         "dist_kernels_1025": dist_kernels, "dist3d": dist3d,
         "dist2d": dist2d, "cycle_kernels": cycle_kernels,
         "fusion": fusion, "mass_quad": mass_quad,
         "mass_quad_path": mass_quad_path, "phase_s": phase_s, "kernels": list(records.values())}, indent=1))
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
