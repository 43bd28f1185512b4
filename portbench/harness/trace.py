"""Reduce a torch.profiler trace (its Chrome-trace JSON) to device
operations, each with the stack of benchmark spans that was open on the
host when it was launched.

A device operation (a kernel, a memcpy or a memset) is linked to the host
call that launched it by the profiler's correlation id; that call's time
on its thread gives the spans around it.  Device busy time is the union
of the operations' intervals; an idle gap is labelled by the innermost
span open on the host when it began.
"""
from __future__ import annotations

import json
from typing import List, NamedTuple, Optional, Tuple

from .spans import REQUEST, SPAN_PREFIXES

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# record_function ranges come as user annotations, the fast form as CPU ops
SPAN_CATS = ("user_annotation", "cpu_op")


class Span(NamedTuple):
    idx: int
    name: str
    start: float      # us
    end: float
    tid: object


class DeviceOp(NamedTuple):
    name: str
    start: float      # us
    dur: float
    stack: Tuple[Span, ...]    # outermost first; () where not linked

    @property
    def end(self) -> float:
        return self.start + self.dur


def load(path) -> list:
    with open(path) as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data


def parse(events: list):
    """(device ops sorted by start, spans sorted by start)."""
    spans, launches, dev = [], {}, []
    for e in events:
        cat = e.get("cat")
        if (cat in SPAN_CATS and e.get("ph") == "X"
                and e.get("name", "").startswith(SPAN_PREFIXES)):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          e["name"], e.get("tid")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e.get("tid"))
        elif cat in DEVICE_CATS and e.get("ph") == "X":
            dev.append(e)
    spans.sort(key=lambda s: (s[0], -s[1]))
    spans = [Span(i, name, s, t, tid)
             for i, (s, t, name, tid) in enumerate(spans)]
    by_tid = {}
    for sp in spans:
        by_tid.setdefault(sp.tid, []).append(sp)
    points = {}
    for k, e in enumerate(dev):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            points.setdefault(launch[1], []).append((launch[0], k))
    stacks = {}
    for tid, pts in points.items():
        pts.sort()
        for (ts, k), st in zip(pts, stacks_at(by_tid.get(tid, []),
                                              [p[0] for p in pts])):
            stacks[k] = st
    ops = [DeviceOp(e.get("name", ""), float(e["ts"]), float(e["dur"]),
                    stacks.get(k, ())) for k, e in enumerate(dev)]
    ops.sort(key=lambda o: o.start)
    return ops, spans


def stacks_at(spans: List[Span], times: List[float]):
    """For sorted times, the spans of one thread (sorted by start,
    properly nested) open at each time, outermost first."""
    out, stack, j = [], [], 0
    for ts in times:
        while j < len(spans) and spans[j].start <= ts:
            while stack and stack[-1].end < spans[j].start:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1].end < ts:
            stack.pop()
        out.append(tuple(stack))
    return out


def union_busy(ops: List[DeviceOp], t0: float, t1: float) -> float:
    """us in [t0, t1] in which some device operation ran."""
    busy, cur_s, cur_e = 0.0, None, None
    for o in ops:
        s, e = max(o.start, t0), min(o.end, t1)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(ops: List[DeviceOp], t0: float,
              t1: float) -> List[Tuple[float, float]]:
    """Gaps in [t0, t1] in which no device operation ran."""
    gaps, cur = [], t0
    for o in ops:
        if o.start > cur:
            gaps.append((cur, min(o.start, t1)))
        cur = max(cur, o.end)
        if cur >= t1:
            break
    if cur < t1:
        gaps.append((cur, t1))
    return [(s, e) for s, e in gaps if e > s]


class TraceView:
    """What per-layer metric readers read: the traced requests' device
    operations and spans."""

    def __init__(self, ops: List[DeviceOp], spans: List[Span]):
        reqs = [s for s in spans if s.name == REQUEST]
        self.requests = reqs
        self.t0 = min(s.start for s in reqs) if reqs else 0.0
        self.t1 = max(s.end for s in reqs) if reqs else 0.0
        # operations the requests launched (the benchmark's own copies of
        # sampled answers, launched between requests, stay out)
        self.ops = [o for o in ops if any(s.name == REQUEST for s in o.stack)]
        self.spans = [s for s in spans
                      if s.end > self.t0 and s.start < self.t1]

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy_us(self) -> float:
        return union_busy(self.ops, self.t0, self.t1)

    def ops_where(self, pred) -> List[DeviceOp]:
        """Operations with a span on their stack that satisfies pred."""
        return [o for o in self.ops if any(pred(s.name) for s in o.stack)]

    def spans_where(self, pred) -> List[Span]:
        return [s for s in self.spans if pred(s.name)]

    @staticmethod
    def total_ms(ops: List[DeviceOp]) -> float:
        return sum(o.dur for o in ops) / 1e3

    def request_of(self, op: DeviceOp) -> Optional[Span]:
        return next((s for s in op.stack if s.name == REQUEST), None)

    def innermost(self, op: DeviceOp, pred) -> Optional[Span]:
        for s in reversed(op.stack):
            if pred(s.name):
                return s
        return None

    def idle_by_label(self):
        """Idle device time in the window, summed by the innermost span
        open on the requests' host thread when each gap began:
        [(label, us)], longest first."""
        gaps = idle_gaps(self.ops, self.t0, self.t1)
        if not gaps or not self.requests:
            return []
        tid = self.requests[0].tid
        mine = [s for s in self.spans if s.tid == tid]
        out = {}
        for (s, e), st in zip(gaps, stacks_at(mine, [g[0] for g in gaps])):
            label = short_name(st[-1].name) if st else "outside spans"
            out[label] = out.get(label, 0.0) + (e - s)
        return sorted(out.items(), key=lambda kv: -kv[1])


def short_name(span_name: str) -> str:
    """A span's name without a dispatch call's argument list."""
    return span_name.split("|", 1)[0]
