"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources in `multigrid_dolfinx_tpu_torch/csrc/*.cu` expose plain C
entry points, so they compile in seconds without PyTorch's headers.  The
build runs at the first CUDA call, never at import, and is keyed on a hash
of the sources and flags: `build/torch_kernels/libmg_torch_<hash>.so`
under the checkout.  Each source compiles to an object in its own nvcc
process, all started together, and one more nvcc links the objects.
`--fmad=false` keeps the kernels' rounding equal to their plain PyTorch
versions (no multiply-add contraction).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
SOURCES = ("stencil3d.cu", "stencil3d_cheby.cu", "stencil3d_tail.cu",
           "stencil3d_norm.cu", "stencil3d_planes.cu", "stencil3d_p2.cu",
           "stencil2d.cu", "stencil2d_planes.cu", "stencil3d_dist.cu",
           "stencil2d_dist.cu", "stencil3d_cycle.cu", "coarse_band.cu")
HEADERS = ("stencil3d.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# entry point -> argument kinds: p pointer (device pointer or stream),
# i int, f float, d double.  Every entry point returns a cudaError_t as int.
SIGNATURES = {
    "mg_rb_sweep_f32": "pppiffp",
    "mg_rb_sweep_f64": "pppiddp",
    "mg_rb_half_sweep_f32": "pppiffip",
    "mg_rb_half_sweep_f64": "pppiddip",
    "mg_rb_sweep2_f32": "pppiffp",
    "mg_rb_sweep2_f64": "pppiddp",
    "mg_rb_residual_restrict_f32": "ppppiiffffp",
    "mg_rb_residual_restrict_f64": "ppppiiddddp",
    "mg_prolong_correct_rb_f32": "ppppiiffp",
    "mg_prolong_correct_rb_f64": "ppppiiddp",
    "mg_restrict_residual_pt_f32": "pppiiffp",
    "mg_restrict_residual_pt_f64": "pppiiddp",
    "mg_restrict_pt_f32": "ppiip",
    "mg_restrict_pt_f64": "ppiip",
    "mg_planes_residual_f32": "ppppipiiip",
    "mg_planes_residual_f64": "ppppipiiip",
    "mg_planes_jacobi_f32": "ppppipiiiffp",
    "mg_planes_jacobi_f64": "ppppipiiiddp",
    "mg_planes_gs_sweep_f32": "pppipiiiip",
    "mg_planes_gs_sweep_f64": "pppipiiiip",
    "mg_planes2_residual_f32": "ppppipiiip",
    "mg_planes2_residual_f64": "ppppipiiip",
    "mg_planes2_jacobi_f32": "ppppipiiiffp",
    "mg_planes2_jacobi_f64": "ppppipiiiddp",
    "mg_planes2_gs_sweep_f32": "pppipiiiip",
    "mg_planes2_gs_sweep_f64": "pppipiiiip",
    "mg_p2_residual_f32": "pppppipip",
    "mg_p2_residual_f64": "pppppipip",
    "mg_p2_jacobi_f32": "pppppipiiffp",
    "mg_p2_jacobi_f64": "pppppipiiddp",
    "mg_p2_mass_quad_f32": "pppppipiip",
    "mg_p2_mass_quad_f64": "pppppipiip",
    "mg_prolong_linear_f32": "pppiip",
    "mg_prolong_linear_f64": "pppiip",
    "mg_residual_f32": "pppiffp",
    "mg_residual_f64": "pppiddp",
    "mg_jacobi_sweep_f32": "pppiffffp",
    "mg_jacobi_sweep_f64": "pppiddddp",
    "mg_cheby_step_f32": "ppppifffffp",
    "mg_cheby_step_f64": "ppppidddddp",
    "mg_tail_down_f32": "pppppiip",
    "mg_tail_down_f64": "pppppiip",
    "mg_tail_up_f32": "ppppppiip",
    "mg_tail_up_f64": "ppppppiip",
    "mg_tet_quad_partials": "i",
    "mg_residual_tet_quad_f32": "ppppiffidp",
    "mg_residual_tet_quad_f64": "ppppiddidp",
    "mg_mass_quad_partials": "i",
    "mg_residual_mass_quad_f32": "pppippiffp",
    "mg_residual_mass_quad_f64": "pppippiddp",
    "mg_jacobi_sweep_2d_f32": "pppifffp",
    "mg_jacobi_sweep_2d_f64": "pppidddp",
    "mg_rb_sweep_2d_f32": "pppip",
    "mg_rb_sweep_2d_f64": "pppip",
    "mg_residual_2d_f32": "pppip",
    "mg_residual_2d_f64": "pppip",
    "mg_restrict_pt_2d_f32": "ppiip",
    "mg_restrict_pt_2d_f64": "ppiip",
    "mg_prolong_linear_2d_f32": "ppiip",
    "mg_prolong_linear_2d_f64": "ppiip",
    "mg_rb_sweep_dist_f32": "ppppppppiiiffp",
    "mg_rb_sweep_dist_f64": "ppppppppiiiddp",
    "mg_jacobi_sweep_dist_f32": "pppppppiiiffffp",
    "mg_jacobi_sweep_dist_f64": "pppppppiiiddddp",
    "mg_residual_dist_f32": "pppppppiiiffp",
    "mg_residual_dist_f64": "pppppppiiiddp",
    "mg_restrict_residual_pt_dist_f32": "pppppppiiiiffp",
    "mg_restrict_residual_pt_dist_f64": "pppppppiiiiddp",
    "mg_prolong_linear_dist_f32": "ppppiiiip",
    "mg_prolong_linear_dist_f64": "ppppiiiip",
    "mg_rb_sweep_dist_2d_f32": "ppppppppiiip",
    "mg_rb_sweep_dist_2d_f64": "ppppppppiiip",
    "mg_jacobi_sweep_dist_2d_f32": "pppppiiifffp",
    "mg_jacobi_sweep_dist_2d_f64": "pppppiiidddp",
    "mg_residual_dist_2d_f32": "pppppiiip",
    "mg_residual_dist_2d_f64": "pppppiiip",
    "mg_restrict_pt_dist_2d_f32": "pppiiiip",
    "mg_restrict_pt_dist_2d_f64": "pppiiiip",
    "mg_prolong_add_dist_2d_f32": "ppppiiiip",
    "mg_prolong_add_dist_2d_f64": "ppppiiiip",
    "mg_coarse_band_solve_f32": "pppppiiiip",
    "mg_coarse_band_solve_f64": "pppppiiiip",
}

_LIB = None
#: nvcc's output of the last build in this process (ptxas register and
#: spill report); None if the library was already built.
build_log: Optional[str] = None


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libmg_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the hashed file already exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(CSRC_DIR / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(f"== {s}\n{log}" for s, log in zip(SOURCES, logs))
    failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    build_log += f"== link\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{build_log}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out


def library():
    """The loaded kernel library (a ctypes.CDLL), built on first use."""
    global _LIB
    if _LIB is None:
        import ctypes

        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                 "f": ctypes.c_float, "d": ctypes.c_double}
        lib = ctypes.CDLL(str(build()))
        for name, sig in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [kinds[k] for k in sig]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
