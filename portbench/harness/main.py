"""One run of one cell: set-up, the measured window, the check, the
result line.

A request takes a problem's data (u* = 1 + a x^2 + b y^2 + c z^2 and the
matching constant f, (a, b, c) drawn from the seed) and returns the
converged u on the device, synchronised; in a rebuild traffic it builds
the hierarchy first, after releasing the previous one.  One client sends
requests back to back (a closed loop).  With --trace 0 the window lasts
`seconds` and gives the end-to-end metrics.  With --trace 1 three passes
of a fixed number of requests give the per-layer metrics: one plain, one
under torch.profiler with the coarse spans (request, ramp, cycle, check,
coarse solve), whose times and idle share carry little of the
benchmark's own host work, and one with each dispatch call in a span too,
for the kernels' device times by entry and call shape.
"""
from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import check, importcheck, spec, stats, trace as tr
from .spans import REQUEST, Spans, span
from .systems import SYSTEMS, coefficients

WARM_INDEX = 1 << 40      # data index of the warm-up requests


class Ctx(NamedTuple):
    """What a per-layer metric reader gets: the traced pass under the
    coarse spans (`view`: times, idle), the pass under the dispatch spans
    too (`dispatch`: device time by dispatch call), the program's counters
    and the described arguments of each dispatch call shape."""

    view: Optional[tr.TraceView]
    dispatch: Optional[tr.TraceView]
    counters: dict
    calls: dict


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class HostCopies:
    """Pinned host buffers for the sampled answers, filled on a side
    stream so that the next request does not wait for the copy."""

    def __init__(self, like: torch.Tensor, count: int):
        self.cuda = like.is_cuda
        self.bufs = [torch.empty(like.shape, dtype=like.dtype,
                                 pin_memory=self.cuda) for _ in range(count)]
        self.stream = torch.cuda.Stream(like.device) if self.cuda else None

    def take(self, u: torch.Tensor) -> torch.Tensor:
        buf = self.bufs.pop()
        if not self.cuda:
            return buf.copy_(u)
        self.stream.wait_stream(torch.cuda.current_stream(u.device))
        with torch.cuda.stream(self.stream):
            buf.copy_(u, non_blocking=True)
        u.record_stream(self.stream)
        return buf

    def wait(self):
        if self.stream is not None:
            self.stream.synchronize()


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             system: str = "port", config: Optional[dict] = None,
             traffic: Optional[dict] = None):
    """Run one cell once; returns the result dict (compared last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec.load_benchmark()
    cell = spec.workload(bench, workload)
    config = config or spec.config(bench, cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    device = torch.device(device)
    spans = Spans() if trace else None
    try:
        return _run(bench, cell, config, traffic, seed, seconds, trace,
                    device, t_start, system, spans)
    finally:
        if spans is not None:
            spans.uninstall()


def _run(bench, cell, config, traffic, seed, seconds, trace, device,
         t_start, system, spans):
    sysobj = SYSTEMS[system](config, traffic, device)
    lo, hi = config["problem"]["coef_range"]
    rebuild = traffic["rebuild"]

    def coef(i):
        return coefficients(seed, i if rebuild else 0, lo, hi)

    # ---- set-up: build, warm up this traffic's request, nothing else
    t = time.perf_counter()
    hier = sysobj.build(coef(WARM_INDEX if rebuild else 0))
    _sync(device)
    build_s_setup = time.perf_counter() - t
    ans, warm = None, 0.0
    for w in range(traffic["warmup"]):
        ans = None
        t = time.perf_counter()
        if rebuild:
            hier = None
            hier = sysobj.build(coef(WARM_INDEX + w))
        ans = sysobj.request(hier)
        _sync(device)
        warm = time.perf_counter() - t
    # a traced run serves one request to start the profiler, then three
    # passes of n_req: plain, under the coarse spans, under the coarse and
    # the dispatch spans
    n_req = traffic["trace_requests"] if trace else None
    n_est = 3 * n_req + 1 if trace else max(1, int(0.8 * seconds
                                              / max(warm, 1e-6)))
    pick_rng = np.random.default_rng([int(seed) % (2 ** 64), 7])
    k = min(traffic["check_sample"], n_est)
    picks = set(int(x) for x in pick_rng.choice(n_est, size=k, replace=False))
    copies = HostCopies(ans.u, k)
    ans = None
    setup_peak = 0
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    kept = []
    st = {"hier": hier, "ans": None, "i": 0, "failed": 0}
    hier = None

    def serve(n=None, secs=None, traced=False):
        """Requests back to back, n of them or for secs: (the window's
        wall seconds, each request's seconds, cycles, build ms)."""
        lat, cyc, build = [], [], []
        t_w0 = time.perf_counter()
        while True:
            if n is not None:
                if len(lat) >= n:
                    break
            elif lat and time.perf_counter() - t_w0 >= secs:
                break
            i = st["i"]
            st["ans"] = None
            t0 = time.perf_counter()
            with span(REQUEST) if traced else contextlib.nullcontext():
                if rebuild:
                    st["hier"] = None
                    st["hier"] = sysobj.build(coef(i))
                    _sync(device)
                    build.append((time.perf_counter() - t0) * 1e3)
                a = st["ans"] = sysobj.request(st["hier"])
                _sync(device)
            lat.append(time.perf_counter() - t0)
            cyc.append(a.cycles)
            st["failed"] += 0 if a.converged else 1
            if i in picks:
                kept.append((coef(i), copies.take(a.u)))
            a = None
            st["i"] = i + 1
        return time.perf_counter() - t_w0, lat, cyc, build

    if not trace:
        setup_s = time.perf_counter() - t_start
        window_s, lat, _, _ = serve(secs=seconds)
    else:
        from torch.profiler import ProfilerActivity, profile

        from multigrid_dolfinx_tpu_torch.ops import cuda as port_cuda
        cuda = device.type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        # one request under a profiler whose trace is dropped: the
        # profiler's own start-up (kineto, CUPTI) falls here, not in pass A
        with profile(activities=acts):
            serve(n=1)
        gc.collect()
        plain = serve(n=n_req)
        # pass A, coarse spans only: times and idle, with little of the
        # benchmark's own host work in them.  Each pass's trace is read
        # before the next profiler starts, which drops the last one's
        # device records.
        spans.install()
        port_cuda.reset_launch_counts()
        with profile(activities=acts) as prof:
            coarse = serve(n=n_req, traced=True)
        launches = sum(port_cuda.launch_counts().values())
        view = export_view(prof) if cuda else None
        # the last profiler's events are garbage now: collect them here
        prof = None
        gc.collect()
        # pass B, each dispatch call in a span of its own: the kernels'
        # device times by entry and call shape
        spans.install_dispatch()
        with profile(activities=acts) as prof:
            fine = serve(n=n_req, traced=True)
        views = (view, export_view(prof) if cuda else None)
        prof = None
        counters = {"build_s_setup": build_s_setup, "cycles": coarse[2],
                    "cycles_dispatch": fine[2], "build_ms": plain[3],
                    "launches": launches, "requests": n_req}
        request_ms = {name: sum(p[1]) / len(p[1]) * 1e3
                      for name, p in (("plain", plain), ("coarse_spans",
                                                         coarse),
                                      ("dispatch_spans", fine))}
    copies.wait()

    importcheck.require_clean("when the window closed")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # ---- the check, once the program's state is freed but the finest
    # level that it judges and the last answer
    i, failed = st["i"], st["failed"]
    finest = sysobj.finest(st["hier"])
    kept.append((coef(i - 1), st["ans"].u))
    st.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    correct, compared = check.judge(config, finest, coef(i - 1), kept,
                                    failed, seed, device)
    finest = kept = None

    result = {"correct": bool(correct), "attempted": i, "failed": failed}
    if trace:
        ctx = Ctx(views[0], views[1], counters, spans.calls)
        values = {m["name"]: spec.metric_reader(m["name"])(ctx)
                  for m in spec.cell_metrics(bench, cell["name"], True)}
    else:
        # `tts_ms.rebuild` is tts_ms in a cell whose class of time has a
        # bound of its own
        e2e = end_to_end(window_s, lat, peak, setup_s)
        values = {m["name"]: e2e[m["name"].split(".", 1)[0]]
                  for m in spec.cell_metrics(bench, cell["name"], False)}
    result["metrics"] = {
        m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
        for m in spec.cell_metrics(bench, cell["name"], trace)
        if values.get(m["name"]) is not None}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(max(setup_peak, peak))}
    if trace and views[0] is not None:
        dev["busy_s"] = views[0].busy_us() / 1e6
        dev["window_s"] = views[0].window_us / 1e6
        result["breakdown"] = breakdown(views[0], views[1])
    result["device"] = dev
    if trace:
        result["request_ms"] = request_ms
        if spans.missing:
            result["missing_spans"] = spans.missing
    result["card"] = card_line() if device.type == "cuda" else "cpu"
    result["compared"] = compared
    # the reference, the metric readers and the work counts were loaded
    # after the window: look again before the result is given
    importcheck.require_clean("before the result")
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return result


def export_view(prof) -> tr.TraceView:
    """The profiler's trace, through a file under TMPDIR, as a view."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return tr.TraceView(*tr.parse(tr.load(path)))
    finally:
        os.unlink(path)


def end_to_end(window_s: float, latencies, peak_bytes: int,
               setup_s: float) -> dict:
    """The end-to-end metrics of an untraced window: the window's wall
    time over the requests completed in it, the 95th percentile of every
    request's latency, the window's peak of allocated device memory and
    the set-up time."""
    return {"tts_ms": window_s / len(latencies) * 1e3,
            "tts_p95_ms": stats.percentile(latencies, 95.0) * 1e3,
            "peak_mem_gb": peak_bytes / 1e9, "setup_s": setup_s}


def kernel_label(name: str) -> str:
    """A kernel's name without its namespaces, template and arguments."""
    base = name.replace("(anonymous namespace)::", "")
    base = base[5:] if base.startswith("void ") else base
    base = base.split("<", 1)[0].split("(", 1)[0]
    return base.rsplit("::", 1)[-1].strip() or name[:40]


def breakdown(view: tr.TraceView, fine: tr.TraceView) -> dict:
    """Device operations by span and kernel from the dispatch pass; idle
    gaps from the coarse pass, whose host work is the program's."""
    from .spans import dispatch_entry

    by = {}
    for op in fine.ops:
        sp = fine.innermost(op, lambda n: True)
        where = "no span" if sp is None else tr.short_name(sp.name)
        entry = None if sp is None else dispatch_entry(sp.name)
        if entry is not None and spec.kernel_cost(entry) is None:
            where += " (unaccounted)"
        key = f"{where}/{kernel_label(op.name)}"
        by[key] = by.get(key, 0.0) + op.dur / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    gaps = [(k, v / 1e6) for k, v in view.idle_by_label()[:10]]
    return {"device_ops": [list(x) for x in ops],
            "idle_gaps": [list(x) for x in gaps]}
