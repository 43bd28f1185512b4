"""CSV history writers — output-format parity with the reference.

File names and row layouts match multigrid.py:345-356 (residual/error per
V-cycle) and the iteration-count append at multigrid.py:297-302.  A copy
of `multigrid_dolfinx_tpu.utils.csv_io` (which cannot be imported without
jax); histories may be numpy arrays or CPU tensors.
"""
from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Optional

import numpy as np


def _clean_history(hist) -> list:
    """Drop NaN padding from fixed-size device history buffers."""
    out = []
    for v in np.asarray(hist).tolist():
        if v is None or (isinstance(v, float) and math.isnan(v)):
            break
        out.append(v)
    return out


def write_residual_csv(
    residual_hist, num_elems_finest: int, num_levels: int, out_dir: str = "."
) -> Path:
    """`residual_for_{N}_{L}_levels.csv`: one row [cycle_index, residual]
    per V-cycle (reference writing_residual_for_mesh_to_csv,
    multigrid.py:345-350)."""
    path = Path(out_dir) / f"residual_for_{num_elems_finest}_{num_levels}_levels.csv"
    hist = _clean_history(residual_hist)
    with open(path, mode="w", newline="") as f:
        w = csv.writer(f, delimiter=",")
        for i, v in enumerate(hist):
            w.writerow([i, v])
    return path


def write_error_csv(
    error_hist, num_elems_finest: int, num_levels: int, out_dir: str = ".",
    reference_error: Optional[float] = None,
) -> Path:
    """`error_for_{N}_{L}_levels.csv` (reference
    writing_error_for_mesh_to_csv, multigrid.py:352-356); optionally append
    the direct-solver comparison row ['Dolf', err] the reference's script
    adds (Multigrid_prototype.py:152-156)."""
    path = Path(out_dir) / f"error_for_{num_elems_finest}_{num_levels}_levels.csv"
    hist = _clean_history(error_hist)
    with open(path, mode="w", newline="") as f:
        w = csv.writer(f, delimiter=",")
        for i, v in enumerate(hist):
            w.writerow([i, v])
        if reference_error is not None:
            w.writerow(["Dolf", reference_error])
    return path


def append_iter_count_csv(
    num_elems_finest: int, num_levels: int, count: int, out_dir: str = "."
) -> Path:
    """`iter_count_for_diff_num_elems_{L}_levels.csv`: append
    [num_elems, V-cycle count] (reference multigrid.py:297-302)."""
    path = Path(out_dir) / f"iter_count_for_diff_num_elems_{num_levels}_levels.csv"
    with open(path, mode="a", newline="") as f:
        w = csv.writer(f, delimiter=",")
        w.writerow([num_elems_finest, count])
    return path
