"""Find everything by name: the cell in BENCHMARK.json, its configuration
file, its traffic file, the per-layer metric readers and the dispatch
entries' work counts, each in a file of its own under portbench/."""
from __future__ import annotations

import functools
import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as fh:
                return json.load(fh)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def applies(metric: dict, cell: str) -> bool:
    """Does this metric belong to this cell's line?"""
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if applies(m, cell)]


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """read(ctx) of portbench/metrics/<name>.py."""
    path = bench_dir / "metrics" / f"{name}.py"
    return _load_file(path, f"portbench_metric_{name}").read


@functools.lru_cache(maxsize=None)
def kernel_cost(entry: str, bench_dir: Path = BENCH_DIR):
    """cost(args) of portbench/kernels/<entry>.py, or None where the
    dispatch entry has no work count."""
    path = bench_dir / "kernels" / f"{entry}.py"
    if not path.exists():
        return None
    return _load_file(path, f"portbench_kernel_{entry}").cost


def reference(name: str):
    return importlib.import_module(f"portbench.reference.{name}")
