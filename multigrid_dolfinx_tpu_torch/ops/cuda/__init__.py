"""Hand-written Hopper kernels of the port and their plain versions.

Importing this package never touches nvcc or ctypes: the library is
built and loaded at the first CUDA launch (ops.cuda.build).
"""
from . import (coarse_band, stencil2d, stencil2d_dist, stencil2d_planes,
               stencil3d, stencil3d_cheby, stencil3d_cycle, stencil3d_dist,
               stencil3d_norm, stencil3d_p2, stencil3d_planes, stencil3d_tail)

_COUNTERS = (stencil3d.LAUNCHES, stencil3d_cheby.LAUNCHES,
             stencil3d_tail.LAUNCHES, stencil3d_norm.LAUNCHES,
             stencil3d_planes.LAUNCHES, stencil3d_p2.LAUNCHES,
             stencil2d.LAUNCHES, stencil2d_planes.LAUNCHES,
             stencil3d_dist.LAUNCHES, stencil2d_dist.LAUNCHES,
             stencil3d_cycle.LAUNCHES, coarse_band.LAUNCHES)


def launch_counts() -> dict:
    """Launch count of every kernel wrapper since the last reset."""
    out = {}
    for counts in _COUNTERS:
        out.update(counts)
    return out


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0
