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
     1.75.
Each main path (5, 7, 9) sets the launch counts to 0 just before it runs
and reads them just after.  The second-to-last line is the kernels' JSON
record (K1-K9, each with the launches of the main path that runs it), the
last line {"ok": true, "device": {...}}.  nvcc's report and the full
record go to --out (default build/chip_smoke/, under the checkout).
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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
}
KERNELS_3D = ("rb_sweep", "restrict_residual_pt", "prolong_linear_add",
              "prolong_linear", "residual_tet_quad")
# the kernels each 2D main path runs
KERNELS_REFERENCE = ("jacobi_sweep_2d", "residual_2d", "prolong_linear_2d")
KERNELS_2D = ("rb_sweep_2d", "residual_2d", "restrict_pt_2d",
              "prolong_linear_2d")
SOURCES = {
    "rb_sweep": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "restrict_residual_pt": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "prolong_linear_add": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "prolong_linear": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "residual_tet_quad": "multigrid_dolfinx_tpu_torch/csrc/stencil3d_norm.cu",
    **{k: "multigrid_dolfinx_tpu_torch/csrc/stencil2d.cu"
       for k in ("jacobi_sweep_2d", "rb_sweep_2d", "residual_2d",
                 "restrict_pt_2d", "prolong_linear_2d")},
}
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
    time_pairs(torch, pairs, err, records, f"phase 3 time at lm={lm}")
    del v, f, c
    torch.cuda.empty_cache()


def time_pairs(torch, pairs, err, records, label):
    """Kernel and plain times, run as plain, kernel, kernel, plain."""
    for name, (kern, plain) in pairs.items():
        p1 = time_ms(torch, plain, reps=3, warmup=1)
        k1 = time_ms(torch, kern)
        k2 = time_ms(torch, kern)
        p2 = time_ms(torch, plain, reps=3, warmup=1)
        records[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": 0,
            "max_abs_err": err[name], "ms": min(k1, k2),
            "plain_ms": min(p1, p2),
        }
        print(f"{label} {name}: kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms")


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
    missing = [k for k in KERNELS_3D if counts.get(k, 0) == 0]
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
    time_pairs(torch, pairs, err, records, f"phase 6 time at lm={lm} f32")
    del v, f, c
    torch.cuda.empty_cache()


def compare_histories(np, name, card, cpu, rtol, atol):
    """Same cycle count and histories within rtol / atol, card vs CPU."""
    k = cpu.num_cycles
    if card.num_cycles != k or not (card.converged and cpu.converged):
        raise AssertionError(f"{name}: card {card.num_cycles} cycles "
                             f"(converged {card.converged}), cpu {k} "
                             f"(converged {cpu.converged})")
    out = {}
    for h in ("res_hist", "err_hist"):
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
    except Exception:
        print(f"FAILED in phase {phase}:")
        traceback.print_exc(file=sys.stdout)
        return 1
    # launches: each kernel's count in the main path that runs it
    for k, rec in records.items():
        rec["launches"] = (counts[k] if k in KERNELS_3D else
                           counts_ref[k] if k == "jacobi_sweep_2d" else
                           counts_2d[k])
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "main": main,
         "reference": reference, "main_2d": main_2d,
         "kernels": list(records.values())}, indent=1))
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
