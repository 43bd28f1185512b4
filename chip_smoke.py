#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--out DIR]

Phases (each prints one line; any failure exits nonzero with no result):
  1. the device: torch's name for it, and nvidia-smi's name and power limit;
  2. build of the CUDA kernels from multigrid_dolfinx_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version on the card, on inputs
     from numpy's default_rng, at lm in {9, 17, 65, 129, 257, 513}, and
     kernel / plain times at the main path's 513^3 / 257^3 shapes;
  4. the slice at 64^3 f32 on the card against the plain path on the CPU;
  5. the main path: 512^3 f32 lean FMG + V(2,2) solve to rtol 1e-8, with
     every kernel's launches counted, and 10 V-cycles timed with CUDA
     events.
The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  nvcc's report and the full record go to
--out (default build/chip_smoke/, under the checkout).  Imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
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
TPU_KERNELS = {
    "rb_sweep": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:574",
    "restrict_residual_pt": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:1051",
    "prolong_linear_add": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:1209",
    "prolong_linear": "multigrid_dolfinx_tpu/ops/pallas/stencil3d.py:1181",
    "residual_tet_quad": "multigrid_dolfinx_tpu/ops/pallas/stencil3d_norm.py:375",
}
SOURCES = {
    "rb_sweep": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "restrict_residual_pt": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "prolong_linear_add": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "prolong_linear": "multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu",
    "residual_tet_quad": "multigrid_dolfinx_tpu_torch/csrc/stencil3d_norm.cu",
}
# K1-K3 must agree to 1e-6 of the reference's magnitude (bitwise is
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

    err = {k: 0.0 for k in TPU_KERNELS}
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
            diff = float((out.double() - ref.double()).abs().max())
            scale = float(ref.double().abs().max())
            err[name] = max(err[name], diff)
            parts.append(f"{name}={diff:.3e}")
            if not diff <= tol * scale:
                raise AssertionError(
                    f"{name} at lm={lm}: max|kernel-plain|={diff:.3e} > "
                    f"{tol} * max|plain| = {tol * scale:.3e}")
        print(f"phase 3 lm={lm}: max|kernel-plain| " + " ".join(parts))
    counts = kcuda.launch_counts()
    missing = [k for k in TPU_KERNELS if counts.get(k, 0) == 0]
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
        print(f"phase 3 time {name} at lm={lm}: kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms")
    del v, f, c
    torch.cuda.empty_cache()


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
    missing = [k for k in TPU_KERNELS if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main path did not launch {missing}")

    v, f, L = res.u.clone(), hier.finest.b, hier.num_levels - 1
    holder = [v]

    def one_cycle():
        holder[0] = mg.vcycle(hier, cyc, L, holder[0], f)

    ms = time_ms(torch, one_cycle, reps=10, warmup=1)
    dofs = lm ** 3
    print(f"phase 5 V-cycle: {ms:.4f} ms/V-cycle, {dofs / (ms * 1e-3):.4e} "
          f"DOF/s at {dofs} DOFs on [{card}]")

    # where the time goes: the V-cycle rooted at each level
    rooted = {}
    for li in range(1, L + 1):
        lv = hier.levels[li]
        held = [torch.zeros_like(lv.b)]

        def level_cycle():
            held[0] = mg.vcycle(hier, cyc, li, held[0], lv.b)

        rooted[lv.n + 1] = time_ms(torch, level_cycle, reps=10, warmup=2)
    print("phase 5 V-cycle rooted at lm (ms): " + ", ".join(
        f"{k}: {t:.4f}" for k, t in rooted.items()))
    return counts, {"build_s": t1 - t0, "solve_s": t2 - t1,
                    "cycles": res.num_cycles, "res_hist": hist,
                    "u_mid": u_mid, "ms_per_vcycle": ms,
                    "dof_per_s": dofs / (ms * 1e-3), "peak_gb": peak_gb,
                    "ms_per_vcycle_rooted_at_lm": rooted}


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
    except Exception:
        print(f"FAILED in phase {phase}:")
        traceback.print_exc(file=sys.stdout)
        return 1
    for k, rec in records.items():
        rec["launches"] = counts[k]
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "main": main,
         "kernels": list(records.values())}, indent=1))
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
