"""Time the cycle-step fusion kernels K35-K37 of the PyTorch port at a set
of tile shapes on one CUDA card: the measurement behind the Shape choices
in multigrid_dolfinx_tpu_torch/csrc/stencil3d_cycle.cu.

For each (TZ, TY, TX, THREADS) of SHAPES it compiles a copy of
stencil3d_cycle.cu with all three kernels set to that shape (nvcc, the
port's flags, one process per shape, all started together) under
build/fusion_tiles/, checks each kernel bitwise against the unfused CUDA
chain it replaces (K1 twice; K1 then K2; K3 then K1) at 513^3 f32, and
times it (CUDA events, the least of 2 x 10 calls) beside the chains.
Prints the card's name and power limit, one line per shape and a JSON
line; exits nonzero if a shape fails to build, launch or agree, or
without a card.  Imports nothing of JAX.

Usage: python3 scripts/fusion_tiles.py
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SHAPES = ((8, 8, 32, 256), (8, 16, 32, 512), (8, 16, 32, 1024),
          (16, 16, 32, 1024), (8, 32, 32, 1024), (8, 16, 64, 1024))
LM = 513
ALIASES = ("Sweep2Shape", "RestrictShape", "ProlongShape")


def variant_source(src, shape):
    """stencil3d_cycle.cu with every kernel's Shape alias set to shape."""
    tz, ty, tx, threads = shape
    for alias in ALIASES:
        src, n = re.subn(rf"using {alias} = Shape<[^>]*>;",
                         f"using {alias} = Shape<{tz}, {ty}, {tx}, "
                         f"{threads}>;", src)
        if n != 1:
            raise RuntimeError(f"{alias} not found in stencil3d_cycle.cu")
    return src


def compile_variants(build):
    out = ROOT / "build" / "fusion_tiles"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC_DIR / "stencil3d_cycle.cu").read_text()
    procs = {}
    for shape in SHAPES:
        name = "tiles_" + "_".join(map(str, shape))
        cu = out / f"{name}.cu"
        cu.write_text(variant_source(src, shape))
        lib = out / f"lib{name}.so"
        procs[shape] = (lib, subprocess.Popen(
            [build._find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
             "-shared", "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for shape, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {shape}:\n{log}")
        libs[shape] = lib
    return libs


def bind(path):
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {"mg_rb_sweep2_f32": [p, p, p, i, f, f, p],
            "mg_rb_residual_restrict_f32": [p, p, p, p, i, i, f, f, f, f, p],
            "mg_prolong_correct_rb_f32": [p, p, p, p, i, i, f, f, p]}
    for name, argtypes in sigs.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA card")
        return 1
    import multigrid_dolfinx_tpu_torch as mg
    from multigrid_dolfinx_tpu_torch.ops.cuda import build
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d as s3

    _, card = chip_smoke.phase_device(torch)
    build.library()
    libs = compile_variants(build)
    lm, lmc = LM, (LM + 1) // 2
    wc, woff = chip_smoke.level_weights(mg, lm)
    rng = np.random.default_rng(chip_smoke.SEED)
    v, f, c = (torch.from_numpy(rng.standard_normal((n,) * 3).astype(
        np.float32)).cuda() for n in (lm, lm, lmc))
    stream = torch.cuda.current_stream().cuda_stream

    def best(fn):
        return min(chip_smoke.time_ms(torch, fn),
                   chip_smoke.time_ms(torch, fn))

    chains = {
        "rb_sweep2": lambda: s3.rb_sweep(s3.rb_sweep(v, f, lm, wc, woff), f,
                                         lm, wc, woff),
        "rb_residual_restrict": lambda: s3.restrict_residual_pt(
            s3.rb_sweep(v, f, lm, wc, woff), f, lm, lmc, wc, woff),
        "prolong_correct_rb": lambda: s3.rb_sweep(
            s3.prolong_linear(c, lm, v), f, lm, wc, woff),
    }
    k1 = s3.rb_sweep(v, f, lm, wc, woff)
    want = {"rb_sweep2": (s3.rb_sweep(k1, f, lm, wc, woff),),
            "rb_residual_restrict": (
                k1, s3.restrict_residual_pt(k1, f, lm, lmc, wc, woff)),
            "prolong_correct_rb": (chains["prolong_correct_rb"](),)}
    chain_ms = {k: best(fn) for k, fn in chains.items()}
    print("unfused CUDA chains at 513^3 f32 (ms): " + ", ".join(
        f"{k} {t:.4f}" for k, t in chain_ms.items()) + f" on [{card}]")
    outs = {"rb_sweep2": (torch.empty_like(v),),
            "rb_residual_restrict": (torch.empty_like(v),
                                     torch.empty_like(c)),
            "prolong_correct_rb": (torch.empty_like(v),)}
    result = {"card": card, "chain_ms": chain_ms, "shapes": {}}
    for shape, path in libs.items():
        lib = bind(path)
        o35, (o36, fc36), o37 = (outs["rb_sweep2"][0],
                                 outs["rb_residual_restrict"],
                                 outs["prolong_correct_rb"][0])
        calls = {
            "rb_sweep2": lambda: lib.mg_rb_sweep2_f32(
                v.data_ptr(), f.data_ptr(), o35.data_ptr(), lm, 1.0 / wc,
                -woff, stream),
            "rb_residual_restrict": lambda: lib.mg_rb_residual_restrict_f32(
                v.data_ptr(), f.data_ptr(), o36.data_ptr(), fc36.data_ptr(),
                lm, lmc, wc, woff, 1.0 / wc, -woff, stream),
            "prolong_correct_rb": lambda: lib.mg_prolong_correct_rb_f32(
                c.data_ptr(), v.data_ptr(), f.data_ptr(), o37.data_ptr(), lmc,
                lm, 1.0 / wc, -woff, stream),
        }
        times = {}
        for name, call in calls.items():
            err = call()
            torch.cuda.synchronize()
            if err != 0 or not all(torch.equal(a, b) for a, b in
                                   zip(outs[name], want[name])):
                raise AssertionError(f"{name} at {shape}: error {err} or not "
                                     "its unfused chain bitwise")
            times[name] = best(call)
        result["shapes"][str(shape)] = times
        print(f"tile {shape} (TZ, TY, TX, threads): bitwise; " + ", ".join(
            f"{k} {t:.4f} ms" for k, t in times.items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
