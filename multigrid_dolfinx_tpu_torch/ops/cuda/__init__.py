"""Hand-written Hopper kernels of the port and their plain versions.

Importing this package never touches nvcc or ctypes: the library is
built and loaded at the first CUDA launch (ops.cuda.build).
"""
from . import stencil3d, stencil3d_norm


def launch_counts() -> dict:
    """Launch count of every kernel wrapper since the last reset."""
    return {**stencil3d.LAUNCHES, **stencil3d_norm.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (stencil3d.LAUNCHES, stencil3d_norm.LAUNCHES):
        for name in counts:
            counts[name] = 0
