"""The benchmark's harness on the CPU: files found by name, the metrics'
arithmetic, the work counts against PERF.md's bounds, the import check,
the reference, trace reduction, and whole runs of every cell at a tiny
size."""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.harness import importcheck, main, peaks, spec, stats
from portbench.harness import trace as tr
from portbench.harness.spans import Arg
from portbench.reference import p1_kuhn as R
from portbench.tests.conftest import tiny

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        cfg = spec.config(BENCH, w["config"])
        assert cfg["name"] == w["config"]
        spec.reference(cfg["reference"])
        assert spec.traffic(w["traffic"])["entry"]
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_a_new_file_is_found_by_name(tmp_path):
    for sub in ("metrics", "kernels", "traffic"):
        (tmp_path / sub).mkdir()
    (tmp_path / "metrics" / "new_metric.x.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (tmp_path / "kernels" / "new_entry.py").write_text(
        "def cost(args):\n    return {'bytes': 1, 'flops': 2}\n")
    (tmp_path / "traffic" / "new_mix.json").write_text(
        json.dumps({"entry": "solve"}))
    assert spec.metric_reader("new_metric.x", tmp_path)(None) == 42.0
    assert spec.kernel_cost("new_entry", tmp_path)([]) == {"bytes": 1,
                                                          "flops": 2}
    assert spec.kernel_cost("no_such_entry", tmp_path) is None
    assert spec.traffic("new_mix", tmp_path) == {"entry": "solve"}


def test_cell_metrics_follow_workloads_lists():
    names = [m["name"] for m in spec.cell_metrics(BENCH, "var384.solve",
                                                  True)]
    assert "planes3_gs_sweep_roofline" in names
    assert "rb_sweep_roofline" not in names
    e2e = [m["name"] for m in spec.cell_metrics(BENCH, "p1_512.solve",
                                                False)]
    assert e2e == ["tts_ms", "tts_p95_ms", "peak_mem_gb", "setup_s"]
    e2e = [m["name"] for m in spec.cell_metrics(BENCH, "var384.solve",
                                                False)]
    assert e2e == ["tts_ms.device_bound", "tts_p95_ms.device_bound",
                   "peak_mem_gb", "setup_s"]


def test_each_layer_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            e2e = [x["name"] for x in spec.cell_metrics(BENCH, cell, False)]
            assert m["moves"] in e2e, (m["name"], cell)


def test_tts_is_window_over_requests_and_p95_over_every_request():
    lat = [0.010] * 95 + [0.050] * 5
    out = main.end_to_end(2.0, lat, 3 * 10 ** 9, 12.5)
    assert out["tts_ms"] == pytest.approx(2.0 / 100 * 1e3)
    assert out["tts_p95_ms"] == pytest.approx(
        np.percentile(lat, 95.0) * 1e3)
    assert out["peak_mem_gb"] == 3.0 and out["setup_s"] == 12.5
    rng = np.random.default_rng(3)
    xs = list(rng.exponential(size=1001))
    for q in (5.0, 50.0, 95.0, 99.0):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def _bound_ms(entry, args):
    work = spec.kernel_cost(entry)(args)
    return peaks.bound_s(work["bytes"], work["flops"], 4) * 1e3


def test_work_counts_give_perf_md_bounds():
    g513 = Arg((513, 513, 513), 4)
    assert _bound_ms("rb_sweep", [g513, g513, Arg(value=513)]) == \
        pytest.approx(0.4836, abs=5e-5)
    assert _bound_ms("residual_tet_quad", [g513, g513, Arg(value=513)]) == \
        pytest.approx(0.3224, abs=5e-5)
    g385 = Arg((385, 385, 385), 4)
    planes = Arg((15, 385, 385, 385), 4)
    assert _bound_ms("planes3_gs_sweep", [g385, g385, planes, []]) == \
        pytest.approx(1.2265, abs=5e-5)
    # K2 at 513^3 -> 257^3, K3 with v
    assert _bound_ms("restrict_residual_pt",
                     [g513, g513, Arg(value=513), Arg(value=257)]) == \
        pytest.approx(0.3427, abs=5e-5)
    assert _bound_ms("prolong_linear", [Arg((257,) * 3, 4), Arg(value=513),
                                        g513]) == \
        pytest.approx(0.3427, abs=5e-5)


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax", True), ("multigrid_dolfinx_tpu", True),
    ("multigrid_dolfinx_tpu.solver.fmg", True),
    ("multigrid_dolfinx_tpu_torch", False),
    ("multigrid_dolfinx_tpu_torch.ops.dispatch", False),
    ("jaxtyping", False), ("torch", False)])
def test_import_check_compares_top_level_names_whole(name, bad):
    assert (importcheck.forbidden_loaded({name: None}) == [name]) is bad


@pytest.fixture
def fake_jax(tmp_path, monkeypatch):
    """A package named jax on sys.path (loaded by `import jax` in place of
    any real one); sys.modules' jax entries are put back afterwards."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    saved = {m: sys.modules.pop(m) for m in list(sys.modules)
             if m.split(".", 1)[0] == "jax"}
    yield tmp_path
    for m in [m for m in sys.modules if m.split(".", 1)[0] == "jax"]:
        del sys.modules[m]
    sys.modules.update(saved)


def test_a_metric_reader_that_loads_jax_leaves_no_result(fake_jax,
                                                         monkeypatch):
    (fake_jax / "metrics").mkdir()
    (fake_jax / "metrics" / "loads_jax.py").write_text(
        "import jax\n\n\ndef read(ctx):\n    return 1.0\n")
    reader = spec.metric_reader
    monkeypatch.setattr(spec, "metric_reader",
                        lambda name: reader("loads_jax", fake_jax))
    w = CELLS[0]
    with pytest.raises(ImportError, match="jax"):
        main.run_cell(w, 3, 0.1, True, device="cpu", config=tiny(w))


def test_run_py_prints_no_result_where_jax_is_loaded(fake_jax, monkeypatch,
                                                     capsys):
    from portbench import run

    def harness_that_loads_jax(*args, **kwargs):
        import jax  # noqa: F401
        return {"correct": True}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(main, "run_cell", harness_that_loads_jax)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == "" and "'jax'" in err


def test_reference_residual_of_a_known_solution_is_zero():
    p = R.Problem(n=8, coef=(1.3, 2.1, 0.7))
    x, y, z = R.node_coords(p, 0, 9, torch.float64, "cpu")
    u = p.exact(x, y, z).expand(9, 9, 9)
    rs, r0, m, m0 = R.residual_norms(p, u, block=3)
    assert r0 > 0.1 and rs / r0 < 1e-14 and m / m0 < 1e-14
    # one node off by 1e-3 is seen by the nodal number
    u2 = u.clone()
    u2[4, 4, 4] += 1e-3
    assert R.residual_norms(p, u2)[2] / m0 > 1e-5


def test_reference_stiffness_is_the_7_point_stencil_for_constant_kappa():
    p = R.Problem(n=6, coef=(1.0, 1.0, 1.0))
    z = torch.zeros((7, 7, 7), dtype=torch.float64)
    z[3, 3, 3] = 1.0
    col = R.stiffness_rows(p, z, 0)
    h = p.h
    assert float(col[3, 3, 3]) == pytest.approx(6 * h)
    for d in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        assert float(col[3 + d[0], 3 + d[1], 3 + d[2]]) == pytest.approx(-h)
    assert float(col.abs().sum()) == pytest.approx(12 * h)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_trace_links_device_ops_to_spans_and_finds_idle():
    events = [
        _ev("user_annotation", "request", 0, 100),
        _ev("user_annotation", "fmg.check_norm", 10, 20),
        _ev("cpu_op", "dispatch.rb_sweep|[x]", 40, 5),
        _ev("cpu_op", "aten::add_", 41, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 41, 1, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=3),
        _ev("kernel", "tet_kernel", 20, 10, tid=7, corr=1),
        _ev("kernel", "rb_kernel", 45, 30, tid=7, corr=2),
        _ev("kernel", "loose_kernel", 80, 10, tid=7, corr=3),
    ]
    view = tr.TraceView(*tr.parse(events))
    assert view.n_requests == 1 and view.window_us == 100
    assert view.busy_us() == 50
    names = {o.name: [s.name for s in o.stack] for o in view.ops}
    assert names["tet_kernel"] == ["request", "fmg.check_norm"]
    assert names["rb_kernel"] == ["request", "dispatch.rb_sweep|[x]"]
    assert names["loose_kernel"] == ["request"]
    idle = dict(view.idle_by_label())
    assert idle == {"request": 35.0, "fmg.check_norm": 15.0}


@pytest.mark.parametrize("name,label", [
    ("void (anonymous namespace)::rb_zmarch_kernel<float, mg3d::ZShape<16, "
     "3> >(float*, float const*, int)", "rb_zmarch_kernel"),
    ("void trsv_ln_exec<double, 32u, 32u, 4u, false>(int, double const*)",
     "trsv_ln_exec"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH")])
def test_breakdown_names_kernels_without_templates(name, label):
    assert main.kernel_label(name) == label


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_run_of_every_cell_is_correct(workload, trace):
    res = main.run_cell(workload, 2 ** 33 + 5, 0.3, bool(trace),
                        device="cpu", config=tiny(workload))
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared"
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in spec.cell_metrics(BENCH, workload, trace)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
        assert all(m["value"] > 0 for n, m in res["metrics"].items()
                   if n.startswith("tts"))
    else:
        assert set(res["request_ms"]) == {"plain", "coarse_spans",
                                          "dispatch_spans"}
        assert res["attempted"] == 1 + 3 * spec.traffic(spec.workload(
            BENCH, workload)["traffic"])["trace_requests"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert kind


def test_an_untraced_run_leaves_the_port_untouched():
    from multigrid_dolfinx_tpu_torch.ops import coarse, dispatch
    from multigrid_dolfinx_tpu_torch.solver import fmg, krylov
    before = (fmg.vcycle, fmg.check_norm, krylov.vcycle, dispatch.rb_sweep,
              coarse.CoarseSolver.solve)
    w = CELLS[0]
    main.run_cell(w, 1, 0.1, False, device="cpu", config=tiny(w))
    main.run_cell(w, 1, 0.1, True, device="cpu", config=tiny(w))
    after = (fmg.vcycle, fmg.check_norm, krylov.vcycle, dispatch.rb_sweep,
             coarse.CoarseSolver.solve)
    assert before == after


def test_the_same_seed_gives_the_same_data():
    from portbench.harness.systems import coefficients
    big = 2 ** 31 + 12345
    assert coefficients(big, 0, 1, 3) == coefficients(big, 0, 1, 3)
    assert coefficients(big, 0, 1, 3) != coefficients(big + 1, 0, 1, 3)
    assert all(1 <= v < 3 for v in coefficients(big, 5, 1, 3))


def test_run_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=root, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.chip
def test_one_short_run_on_the_card(need_chip):
    res = main.run_cell(CELLS[0], 7, 2.0, False, device="cuda")
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert math.isfinite(res["metrics"]["tts_ms"]["value"])
