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
     and 129^3 with and without the tail.
Each main path (5, 7, 9 and each run of 12) sets the launch counts to 0
just before it runs and reads them just after.  Each kernel's record
carries its time, its plain version's, the time of one PyTorch call that
computes the same function where there is one (library_ms, else null;
never called by the port) and its bound: the larger of the bytes it must
move over 3.35 TB/s and its f32 operations over 67 TFLOP/s (H100 SXM).
The second-to-last line is the kernels' JSON record (K1-K14, each with
the launches of the main path that runs it), the last line {"ok": true,
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
}
KERNELS_3D = ("rb_sweep", "restrict_residual_pt", "prolong_linear_add",
              "prolong_linear", "residual_tet_quad")
# the kernels each 2D main path runs
KERNELS_REFERENCE = ("jacobi_sweep_2d", "residual_2d", "prolong_linear_2d")
KERNELS_2D = ("rb_sweep_2d", "residual_2d", "restrict_pt_2d",
              "prolong_linear_2d")
KERNELS_SLICE3 = ("residual", "jacobi_sweep", "cheby_step")
KERNELS_TAIL = ("tail_down", "tail_up")
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
}
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s and f32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# f32 operations per fine point (per coarse point for the '_c' entries),
# counted from each kernel's arithmetic in csrc/: the neighbour sum is 5
# adds in 3D and 3 in 2D, the const-7 residual 9, the [1 2 1] restriction
# 40 per 3D coarse point and 13 per 2D one, the per-tet norm 54 per cell.
OPS = {"rb_sweep": 8, "restrict_residual_pt": 9, "restrict_residual_pt_c": 40,
       "prolong_linear": 3, "prolong_linear_add": 4, "residual_tet_quad": 63,
       "jacobi_sweep_2d": 8, "rb_sweep_2d": 5, "residual_2d": 6,
       "restrict_pt_2d": 0, "restrict_pt_2d_c": 13, "prolong_linear_2d": 2,
       "residual": 9, "jacobi_sweep": 11, "cheby_step": 14}
# f32 arrays of fine points each kernel reads or writes once (fine, coarse)
ARRAYS = {"rb_sweep": (3, 0), "restrict_residual_pt": (2, 1),
          "prolong_linear": (1, 1), "prolong_linear_add": (2, 1),
          "residual_tet_quad": (2, 0), "jacobi_sweep_2d": (3, 0),
          "rb_sweep_2d": (3, 0), "residual_2d": (3, 0),
          "restrict_pt_2d": (1, 1), "prolong_linear_2d": (1, 1),
          "residual": (3, 0), "jacobi_sweep": (3, 0), "cheby_step": (4, 0)}
RTOL_64 = {"C": 1e-7, "G1": 1e-6}     # above the f32 floor at 64^3
# K1-K3 and K5-K9 must agree to 1e-6 of the reference's magnitude (bitwise is
# expected: same association order, kernels built with --fmad=false); K4
# to 1e-5 relative (its f64 sum runs in another order than torch.sum).
TOL_STENCIL = 1e-6
TOL_NORM = 1e-5


def cycle_spec(mg, rtol):
    return mg.CycleSpec(nu1=2, nu2=2, smoother="rbgs", restriction="pt",
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


def time_pairs(torch, pairs, err, records, label, shape, library=None):
    """Kernel and plain times, run as plain, kernel, kernel, plain, and
    the library call's time where there is one; shape[name] = (fine
    points, coarse points) of the timed call, for its bound."""
    library = library or {}
    for name, (kern, plain) in pairs.items():
        p1 = time_ms(torch, plain, reps=3, warmup=1)
        k1 = time_ms(torch, kern)
        k2 = time_ms(torch, kern)
        p2 = time_ms(torch, plain, reps=3, warmup=1)
        lib = library.get(name)
        lib_ms = min(time_ms(torch, lib), time_ms(torch, lib)) if lib else None
        bound_ms, bound_by = bound(name, *shape[name])
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
    try:
        import numpy as np

        import multigrid_dolfinx_tpu_torch as mg
        from multigrid_dolfinx_tpu_torch.ops.cuda import build

        if "jax" in sys.modules:
            raise AssertionError("jax was imported")
        phase = "1 device"
        name, card = phase_device(torch)
        phase = "2 build"
        out_dir.mkdir(parents=True, exist_ok=True)
        build_s = phase_build(build, out_dir)
        records = {}
        phase = "3 kernels"
        phase_kernels(torch, np, mg, records)
        phase = "4 slice 64^3"
        phase_small_slice(torch, np, mg)
        phase = "5 main path 512^3"
        counts, main = phase_main(torch, np, mg, card)
        phase = "6 kernels 2D"
        phase_kernels_2d(torch, np, records)
        phase = "7 reference run"
        counts_ref, reference = phase_reference(torch, np, mg)
        phase = "8 2D 2049^2"
        phase_2d_small(torch, np, mg)
        phase = "9 2D main path 8193^2"
        counts_2d, main_2d = phase_main_2d(torch, np, mg, card)
        phase = "10 kernels K10-K12"
        phase_kernels_slice3(torch, np, mg, records)
        phase = "11 slice 3 at 64^3"
        phase_small_slice3(torch, np, mg)
        phase = "12 BASELINE configs 3 and 5 at 512^3"
        counts_s3, slice3 = phase_slice3(torch, np, mg, card)
        phase = "13 fused coarse tail"
        tail = phase_tail(torch, np, mg, records)
    except Exception:
        print(f"FAILED in phase {phase}:")
        traceback.print_exc(file=sys.stdout)
        return 1
    # launches: each kernel's count in the main path that runs it
    for k, rec in records.items():
        rec["launches"] = (counts[k] if k in KERNELS_3D + KERNELS_TAIL else
                           counts_ref[k] if k == "jacobi_sweep_2d" else
                           counts_s3[k] if k in KERNELS_SLICE3 else
                           counts_2d[k])
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "main": main,
         "reference": reference, "main_2d": main_2d, "slice3": slice3,
         "tail": tail,
         "kernels": list(records.values())}, indent=1))
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
