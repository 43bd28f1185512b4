"""Time the z-marching kernels K1 (rb_sweep) and K4 (residual_tet_quad) of
the PyTorch port at a set of tile shapes and copy depths on one CUDA card:
the measurement behind SweepShape in multigrid_dolfinx_tpu_torch/csrc/
stencil3d.cu and QuadShape in csrc/stencil3d_norm.cu.

For each (TY, TX, THREADS, DEPTH[, MINB]) of K1_SHAPES and K4_SHAPES
(MINB: the blocks an SM that __launch_bounds__ asks for) it compiles a
copy of the kernel's source with that shape (nvcc, the port's flags, one
process per copy, all started together, its ptxas report beside it)
under build/zmarch_tiles/, checks it against the plain version (K1
bitwise, K4 within chip_smoke.TOL_NORM and two calls bitwise equal) at
lm 100 and 513 in f32 and lm 100 and 200 in f64, and times it at 513^3
f32 (CUDA events, the least of 2 x 10 calls) beside what it replaces or
is held against, in turns: K1 beside the two half sweeps (red out of
place, then black in place: the one-colour design K1 was before), K4
beside K38 on the same v, f.  Prints the card's name and power limit,
one line per shape and a JSON line; exits nonzero if a shape fails to
build, launch or agree, or without a card.  Imports nothing of JAX.

Usage: python3 scripts/zmarch_tiles.py
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

K1_SHAPES = ((16, 32, 256, 1, 2), (16, 32, 256, 1, 1), (16, 64, 256, 1, 2),
             (32, 32, 256, 1, 2), (8, 64, 256, 1, 2), (16, 32, 512, 1, 1))
K4_SHAPES = ((16, 32, 256, 1, 2), (16, 32, 256, 1, 1), (16, 64, 256, 1, 2),
             (32, 32, 256, 1, 2), (8, 64, 256, 1, 2), (16, 32, 512, 1, 1))
LM = 513
KERNELS = {"rb_sweep": ("stencil3d.cu", "SweepShape", K1_SHAPES),
           "residual_tet_quad": ("stencil3d_norm.cu", "QuadShape", K4_SHAPES)}


def variant_source(src, alias, shape):
    """The kernel's source with its shape alias set to shape."""
    args = ", ".join(map(str, shape))
    src, n = re.subn(rf"using {alias} = mg3d::ZShape<[^>]*>;",
                     f"using {alias} = mg3d::ZShape<{args}>;", src)
    if n != 1:
        raise RuntimeError(f"{alias} not found")
    return src


def compile_variants(build):
    out = ROOT / "build" / "zmarch_tiles"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, (source, alias, shapes) in KERNELS.items():
        src = (build.CSRC_DIR / source).read_text()
        for shape in shapes:
            name = f"{kernel}_" + "_".join(map(str, shape))
            cu = out / f"{name}.cu"
            cu.write_text(variant_source(src, alias, shape))
            lib = out / f"lib{name}.so"
            procs[kernel, shape] = (lib, subprocess.Popen(
                [build._find_nvcc(), *build.NVCC_FLAGS, "-I",
                 str(build.CSRC_DIR), "-shared", "-o", str(lib), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = lib
    return libs


def bind(path):
    lib = ctypes.CDLL(str(path))
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
             "d": ctypes.c_double}
    from multigrid_dolfinx_tpu_torch.ops.cuda import build

    for name, sig in build.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [kinds[k] for k in sig]
            fn.restype = ctypes.c_int
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
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_norm as sn

    _, card = chip_smoke.phase_device(torch)
    main_lib = build.library()
    libs = compile_variants(build)
    if build.build_log is not None:
        (ROOT / "build" / "zmarch_tiles" / "library.log").write_text(
            build.build_log)
    rng = np.random.default_rng(chip_smoke.SEED)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    inputs = {(lm, dtype): tuple(torch.from_numpy(rng.standard_normal(
        (lm,) * 3)).to(dev, dtype) for _ in range(2)) for lm, dtype in (
        (100, torch.float32), (LM, torch.float32), (100, torch.float64),
        (200, torch.float64))}

    def k1_call(lib, v, f, out, lm):
        wc, woff = chip_smoke.level_weights(mg, lm)
        fn = getattr(lib, f"mg_rb_sweep_{s3.suffix(v.dtype)}")
        return lambda: fn(v.data_ptr(), f.data_ptr(), out.data_ptr(), lm,
                          1.0 / wc, -woff, stream)

    def k4_call(lib, v, f, lm):
        wc, woff = chip_smoke.level_weights(mg, lm)
        parts = torch.empty(lib.mg_tet_quad_partials(lm), dtype=torch.float64,
                            device=dev)
        out = torch.empty(1, dtype=torch.float64, device=dev)
        fn = getattr(lib, f"mg_residual_tet_quad_{s3.suffix(v.dtype)}")
        scale = (1.0 / (lm - 1)) ** 3 / 120.0
        return out, lambda: fn(v.data_ptr(), f.data_ptr(), parts.data_ptr(),
                               out.data_ptr(), lm, wc, woff, 0, scale, stream)

    def best(fn):
        return min(chip_smoke.time_ms(torch, fn),
                   chip_smoke.time_ms(torch, fn))

    result = {"card": card, "K1": {}, "K4": {}}
    v, f = inputs[LM, torch.float32]
    wc, woff = chip_smoke.level_weights(mg, LM)
    out = torch.empty_like(v)

    def halves():
        for src, color in ((v, 0), (out, 1)):
            err = main_lib.mg_rb_half_sweep_f32(
                src.data_ptr(), f.data_ptr(), out.data_ptr(), LM, 1.0 / wc,
                -woff, color, stream)
            if err:
                raise RuntimeError(f"half sweep: CUDA error {err}")

    offs, tables = chip_smoke.mass_tables(torch, mg, LM, "right",
                                          torch.float32, dev)

    def k38():
        return sn.residual_mass_quad(v, f, tables, offs, LM, wc, woff)

    for (kernel, shape), path in libs.items():
        lib = bind(path)
        for (lm, dtype), (a, b) in inputs.items():
            wl, wo = chip_smoke.level_weights(mg, lm)
            if kernel == "rb_sweep":
                got = torch.empty_like(a)
                err = k1_call(lib, a, b, got, lm)()
                ref = s3.rb_sweep_ref(a, b, lm, wl, wo)
                torch.cuda.synchronize()
                ok = err == 0 and torch.equal(got, ref)
            else:
                q, call = k4_call(lib, a, b, lm)
                err = call()
                q1 = q.clone()
                err = err or call()
                ref = sn.residual_tet_quad_ref(a, b, lm, wl, wo, "right")
                torch.cuda.synchronize()
                ok = (err == 0 and torch.equal(q1, q) and
                      abs(float(q[0]) - float(ref)) <=
                      chip_smoke.TOL_NORM * abs(float(ref)))
            if not ok:
                raise AssertionError(f"{kernel} {shape} at lm={lm} {dtype}: "
                                     f"error {err} or not its plain version")
        if kernel == "rb_sweep":
            call = k1_call(lib, v, f, torch.empty_like(v), LM)
            base, base_name = halves, "two half sweeps"
        else:
            call = k4_call(lib, v, f, LM)[1]
            base, base_name = k38, "K38"
        b1, t1, t2, b2 = best(base), best(call), best(call), best(base)
        key = "K1" if kernel == "rb_sweep" else "K4"
        result[key][str(shape)] = {"ms": min(t1, t2), "base_ms": min(b1, b2)}
        print(f"{key} tile {shape} (TY, TX, threads, depth[, min blocks]): "
              f"checked; {t1:.4f}/{t2:.4f} ms, {base_name} {b1:.4f}/"
              f"{b2:.4f} ms at {LM}^3 f32")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
