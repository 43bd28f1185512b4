"""Time the z-marching kernels K1 (rb_sweep), K2 (restrict_residual_pt),
K3 (prolong_linear, with and without v) and K4 (residual_tet_quad) of the
PyTorch port at a set of tile shapes and copy depths on one CUDA card:
the measurement behind SweepShape, RestrictMarchShape and
ProlongMarchShape in multigrid_dolfinx_tpu_torch/csrc/stencil3d.cu and
QuadShape in csrc/stencil3d_norm.cu.

For each (TY, TX, THREADS, DEPTH, MINB) of a kernel's shapes (K1_SHAPES
.. K4_SHAPES; K2's tile counts coarse columns, the others' fine ones;
MINB: the blocks an SM that __launch_bounds__ asks for) it compiles a
copy of the kernel's source with that shape (nvcc, the port's flags, one
process per copy, all started together, its ptxas report beside it)
under build/zmarch_tiles/, checks it against the plain version and times
it at 513^3 f32 (CUDA events, the least of 2 x 10 calls) beside what it
replaces or is held against, in turns:
  K1: bitwise rb_sweep_ref at lm 100 and 513 in f32 and 100 and 200 in
      f64; beside the two half sweeps (red out of place, then black in
      place: the one-colour design K1 was before);
  K2: bitwise restrict_residual_pt_ref at lm 101 and 513 in f32 and 101
      and 201 in f64; beside the chain K10 residual -> K18 restrict_pt,
      which computes the same function (bitwise, checked at 513^3);
  K3: both forms bitwise prolong_linear_ref at the sizes of K2; with v
      beside F.interpolate(trilinear, align_corners) + v, without v
      beside F.interpolate;
  K4: within chip_smoke.TOL_NORM of residual_tet_quad_ref and two calls
      bitwise equal at the sizes of K1; beside K38 on the same v, f.
Prints the card's name and power limit, one line per shape and a JSON
line; exits nonzero if a shape fails to build, launch or agree, or
without a card.  Imports nothing of JAX.

Usage: python3 scripts/zmarch_tiles.py [KERNEL ...]
  KERNEL: rb_sweep, restrict_residual_pt, prolong_linear,
  residual_tet_quad (default: all four)
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
K2_SHAPES = ((8, 32, 256, 1, 4), (8, 32, 256, 1, 3), (8, 32, 256, 2, 3),
             (8, 64, 256, 1, 2), (16, 32, 256, 1, 2), (4, 64, 256, 1, 4),
             (4, 64, 256, 1, 3), (4, 64, 256, 2, 3), (4, 32, 128, 1, 8))
K3_SHAPES = ((4, 128, 256, 1, 8), (4, 128, 256, 1, 4), (8, 64, 256, 1, 4),
             (8, 64, 256, 1, 8), (8, 128, 256, 1, 4), (4, 256, 256, 1, 4),
             (16, 64, 256, 1, 4), (16, 64, 256, 2, 4), (16, 64, 512, 1, 2))
K4_SHAPES = ((16, 32, 256, 1, 2), (16, 32, 256, 1, 1), (16, 64, 256, 1, 2),
             (32, 32, 256, 1, 2), (8, 64, 256, 1, 2), (16, 32, 512, 1, 1))
LM = 513
KERNELS = {
    "rb_sweep": ("K1", "stencil3d.cu", "SweepShape", K1_SHAPES),
    "restrict_residual_pt": ("K2", "stencil3d.cu", "RestrictMarchShape",
                             K2_SHAPES),
    "prolong_linear": ("K3", "stencil3d.cu", "ProlongMarchShape", K3_SHAPES),
    "residual_tet_quad": ("K4", "stencil3d_norm.cu", "QuadShape", K4_SHAPES),
}
# (lm, dtype name) of each kernel's checks: K2 and K3 need odd lm
EVEN_SIZES = ((100, "float32"), (LM, "float32"), (100, "float64"),
              (200, "float64"))
ODD_SIZES = ((101, "float32"), (LM, "float32"), (101, "float64"),
             (201, "float64"))


def variant_source(src, alias, shape):
    """The kernel's source with its shape alias set to shape."""
    args = ", ".join(map(str, shape))
    src, n = re.subn(rf"using {alias} = mg3d::ZShape<[^>]*>;",
                     f"using {alias} = mg3d::ZShape<{args}>;", src)
    if n != 1:
        raise RuntimeError(f"{alias} not found")
    return src


def compile_variants(build, kernels):
    out = ROOT / "build" / "zmarch_tiles"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel in kernels:
        _, source, alias, shapes = KERNELS[kernel]
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


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA card")
        return 1
    kernels = argv or list(KERNELS)
    unknown = [k for k in kernels if k not in KERNELS]
    if unknown:
        print(f"FAILED: unknown kernels {unknown}; choose from "
              f"{list(KERNELS)}")
        return 2
    import multigrid_dolfinx_tpu_torch as mg
    from multigrid_dolfinx_tpu_torch.ops.cuda import build
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d as s3
    from multigrid_dolfinx_tpu_torch.ops.cuda import stencil3d_norm as sn

    _, card = chip_smoke.phase_device(torch)
    main_lib = build.library()
    libs = compile_variants(build, kernels)
    if build.build_log is not None:
        (ROOT / "build" / "zmarch_tiles" / "library.log").write_text(
            build.build_log)
    rng = np.random.default_rng(chip_smoke.SEED)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cache = {}

    def inputs(lm, dtype_name):
        """(v, f, c) at lm, made once: v, f fine, c on the coarse box."""
        if (lm, dtype_name) not in cache:
            dtype = getattr(torch, dtype_name)
            cache[lm, dtype_name] = tuple(
                torch.from_numpy(rng.standard_normal((n,) * 3)).to(dev, dtype)
                for n in (lm, lm, (lm + 1) // 2))
        return cache[lm, dtype_name]

    def k1_call(lib, v, f, out, lm):
        wc, woff = chip_smoke.level_weights(mg, lm)
        fn = getattr(lib, f"mg_rb_sweep_{s3.suffix(v.dtype)}")
        return lambda: fn(v.data_ptr(), f.data_ptr(), out.data_ptr(), lm,
                          1.0 / wc, -woff, stream)

    def k2_call(lib, v, f, out, lm):
        wc, woff = chip_smoke.level_weights(mg, lm)
        fn = getattr(lib, f"mg_restrict_residual_pt_{s3.suffix(v.dtype)}")
        return lambda: fn(v.data_ptr(), f.data_ptr(), out.data_ptr(), lm,
                          (lm + 1) // 2, wc, woff, stream)

    def k3_call(lib, c, v, out, lm):
        fn = getattr(lib, f"mg_prolong_linear_{s3.suffix(c.dtype)}")
        return lambda: fn(c.data_ptr(), None if v is None else v.data_ptr(),
                          out.data_ptr(), (lm + 1) // 2, lm, stream)

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

    def checked(err, ok, kernel, shape, lm, dtype_name):
        if err != 0 or not ok:
            raise AssertionError(f"{kernel} {shape} at lm={lm} {dtype_name}: "
                                 f"error {err} or not its plain version")

    def check(kernel, lib, shape):
        """The variant against its plain version at its check sizes."""
        sizes = EVEN_SIZES if kernel in ("rb_sweep", "residual_tet_quad") \
            else ODD_SIZES
        for lm, dtype_name in sizes:
            a, b, c = inputs(lm, dtype_name)
            wl, wo = chip_smoke.level_weights(mg, lm)
            lmc = (lm + 1) // 2
            if kernel == "rb_sweep":
                got = torch.empty_like(a)
                err = k1_call(lib, a, b, got, lm)()
                ref = s3.rb_sweep_ref(a, b, lm, wl, wo)
                torch.cuda.synchronize()
                checked(err, torch.equal(got, ref), kernel, shape, lm,
                        dtype_name)
            elif kernel == "restrict_residual_pt":
                got = torch.full_like(c, float("nan"))
                err = k2_call(lib, a, b, got, lm)()
                ref = s3.restrict_residual_pt_ref(a, b, lm, lmc, wl, wo)
                torch.cuda.synchronize()
                checked(err, torch.equal(got, ref), kernel, shape, lm,
                        dtype_name)
            elif kernel == "prolong_linear":
                for vv in (None, a):
                    got = torch.full_like(a, float("nan"))
                    err = k3_call(lib, c, vv, got, lm)()
                    ref = s3.prolong_linear_ref(c, lm, vv)
                    torch.cuda.synchronize()
                    checked(err, torch.equal(got, ref), kernel, shape, lm,
                            dtype_name)
                    del got, ref
            else:
                q, call = k4_call(lib, a, b, lm)
                err = call()
                q1 = q.clone()
                err = err or call()
                ref = sn.residual_tet_quad_ref(a, b, lm, wl, wo, "right")
                torch.cuda.synchronize()
                checked(err, torch.equal(q1, q) and
                        abs(float(q[0]) - float(ref)) <=
                        chip_smoke.TOL_NORM * abs(float(ref)), kernel, shape,
                        lm, dtype_name)
            torch.cuda.empty_cache()

    v, f, c = inputs(LM, "float32")
    wc, woff = chip_smoke.level_weights(mg, LM)
    lmc = (LM + 1) // 2
    out = torch.empty_like(v)
    F = torch.nn.functional

    def halves():
        for src, color in ((v, 0), (out, 1)):
            err = main_lib.mg_rb_half_sweep_f32(
                src.data_ptr(), f.data_ptr(), out.data_ptr(), LM, 1.0 / wc,
                -woff, color, stream)
            if err:
                raise RuntimeError(f"half sweep: CUDA error {err}")

    def chain():
        return s3.restrict_pt(s3.residual(v, f, LM, wc, woff), LM, lmc)

    def interp():
        return F.interpolate(c[None, None], size=(LM,) * 3, mode="trilinear",
                             align_corners=True)[0, 0]

    if "restrict_residual_pt" in kernels:
        if not torch.equal(chain(), s3.restrict_residual_pt_ref(
                v, f, LM, lmc, wc, woff)):
            raise AssertionError("K10 -> K18 is not restrict_residual_pt_ref")
    tables = None
    if "residual_tet_quad" in kernels:
        tables = chip_smoke.mass_tables(torch, mg, LM, "right", torch.float32,
                                        dev)

    def k38():
        return sn.residual_mass_quad(v, f, tables[1], tables[0], LM, wc, woff)

    result = {"card": card}
    for _ in range(2):       # the card's clocks settle before the first turn
        best(lambda: out.copy_(v))
    for (kernel, shape), path in libs.items():
        lib = bind(path)
        check(kernel, lib, shape)
        key = KERNELS[kernel][0]
        if kernel == "rb_sweep":
            timed = {"": (k1_call(lib, v, f, torch.empty_like(v), LM), halves,
                          "two half sweeps")}
        elif kernel == "restrict_residual_pt":
            timed = {"": (k2_call(lib, v, f, torch.empty_like(c), LM), chain,
                          "K10 -> K18")}
        elif kernel == "prolong_linear":
            timed = {" with v": (k3_call(lib, c, v, torch.empty_like(v), LM),
                                 lambda: interp() + v,
                                 "F.interpolate + v"),
                     " without v": (k3_call(lib, c, None, torch.empty_like(v),
                                            LM), interp, "F.interpolate")}
        else:
            timed = {"": (k4_call(lib, v, f, LM)[1], k38, "K38")}
        for form, (call, base, base_name) in timed.items():
            b1, t1, t2, b2 = best(base), best(call), best(call), best(base)
            result.setdefault(key + form, {})[str(shape)] = {
                "ms": min(t1, t2), "base_ms": min(b1, b2)}
            print(f"{key}{form} tile {shape} (TY, TX, threads, depth, min "
                  f"blocks): checked; {t1:.4f}/{t2:.4f} ms, {base_name} "
                  f"{b1:.4f}/{b2:.4f} ms at {LM}^3 f32", flush=True)
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
