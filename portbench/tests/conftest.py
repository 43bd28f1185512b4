"""Tests of the port's benchmark.  They run on the CPU at tiny sizes;
those that need the CUDA card are marked `chip` and skip without one
(the decision is made inside the test)."""
import copy

import pytest
import torch

from portbench.harness import spec


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs the CUDA card; skips without one")


@pytest.fixture
def need_chip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny_config(name: str, finest_level: int = 2, coarsest_level: int = 0,
                rtol: float = None) -> dict:
    """A configuration of BENCHMARK.json cut to a CPU-sized grid: the same
    problem, cycle and check limits, fewer levels (and, where given, a
    looser rtol, which a tiny grid in f32 needs: its floor lies higher)."""
    c = copy.deepcopy(spec.config(spec.load_benchmark(), name))
    hs = c["hierarchy"]
    hs.update(finest_level=finest_level, coarsest_level=coarsest_level)
    c["problem"]["elements"] = hs["coarsest_elements"] * 2 ** finest_level
    if rtol is not None:
        c["cycle"]["rtol"] = rtol
    return c


def tiny(workload: str) -> dict:
    cell = spec.workload(spec.load_benchmark(), workload)
    if cell["config"] == "poisson3d_p1_512":
        return tiny_config(cell["config"], rtol=1e-6)
    return tiny_config(cell["config"])
