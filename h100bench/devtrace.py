"""A traced window: ``torch.profiler`` over a few calls, read from its
Chrome trace.

The host's per-operator events cost time on the host, enough to idle the
card in a step of thousands of small operators. So a traced run profiles
the same calls twice (``Traced``): with the host's activity too, which
gives the spans, the launches under them, and what the host was doing in
each idle gap; then with the device's activity alone, which gives the
busy time, the window and the device operators.

CUPTI now and then drops some or most of a window's kernel records (F5).
A host window in which more than 1% of the launches have no kernel record
is profiled again; so is a device window with more than 1% fewer kernel
records than the host window that it repeats, since it records no
launches of its own to hold them against. Each up to ``WINDOWS`` times.
The trace file goes to ``TMPDIR`` under a name unique to the process and
is deleted once read.

Times in the trace are microseconds; everything returned is seconds.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOWS = 4
CALL_SPAN = "h100bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Span:
    """A ``torch.profiler.record_function`` region opened and closed by
    separate calls, as forward hooks need."""

    def __init__(self, name: str):
        self.name, self.open = name, []

    def enter(self) -> None:
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        self.open.append(rf)

    def exit(self) -> None:
        self.open.pop().__exit__(None, None, None)


def hook_span(modules, name: str) -> Callable[[], None]:
    """Wrap every forward of ``modules`` in the span ``name``; returns the
    function that takes the hooks off again."""
    span = Span(name)
    handles = []
    for m in modules:
        handles.append(m.register_forward_pre_hook(lambda *a: span.enter()))
        handles.append(m.register_forward_hook(lambda *a: span.exit()))
    return lambda: [h.remove() for h in handles]


class Laps:
    """Host seconds between calls: ``lap(name)`` books the time since the
    last lap under ``name``."""

    def __init__(self):
        self.phases: Dict[str, float] = {}
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = now - self.t
        self.t = now


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    def __init__(self, events: List[dict]):
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in events if e.get("cat") in HOST_CATS]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        calls = [e for e in self.host if e["name"] == CALL_SPAN]
        self.main_tid = calls[0]["tid"] if calls else None
        if calls:
            self.t0 = min(e["ts"] for e in calls)
            self.t1 = max(e["ts"] + e["dur"] for e in calls)
        else:  # no host events: from the first launch to the device's last end
            starts = [e["ts"] for e in self.launches() or self.device]
            self.t0 = min(starts, default=0.0)
            self.t1 = max((e["ts"] + e["dur"] for e in self.device), default=0.0)
        self.busy_intervals = _merge(
            [(max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
             for e in self.device if e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0])

    def launches(self) -> List[dict]:
        return [e for e in self.host if e["cat"] in ("cuda_runtime", "cuda_driver")
                and "Launch" in e["name"]]

    def dropped_share(self) -> float:
        """Share of the kernel launches with no kernel record (all of them
        where no kernel was recorded; none where no launch was)."""
        launches = [e.get("args", {}).get("correlation") for e in self.launches()]
        if not self.kernels:
            return 1.0
        if not launches:
            return 0.0
        seen = {e.get("args", {}).get("correlation") for e in self.kernels}
        return sum(c not in seen for c in launches) / len(launches)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals) / 1e6

    def device_s_under(self, span: str) -> float:
        """Device seconds of the kernels launched inside ``span``."""
        regions = sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in self.host
                         if e["name"] == span)
        if not regions:
            return 0.0
        starts = [r[0] for r in regions]
        inside = set()
        for e in self.launches():
            i = bisect.bisect_right(starts, e["ts"]) - 1
            # spans of one name do not nest here, so the latest start decides
            if i >= 0 and e["ts"] <= regions[i][1] and e["tid"] == regions[i][2]:
                inside.add(e.get("args", {}).get("correlation"))
        return sum(e["dur"] for e in self.kernels
                   if e.get("args", {}).get("correlation") in inside) / 1e6

    def top_device_ops(self, n: int = 10) -> List[list]:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for e in self.device:
            if self.t0 <= e["ts"] < self.t1:
                by_name[e["name"]] += e["dur"] / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle device time in the window, summed by the innermost host
        region of the calling thread at each gap's midpoint."""
        edges = [self.t0] + [x for iv in self.busy_intervals for x in iv] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in self.host
                      if e["tid"] == self.main_tid)
        by_name: Dict[str, float] = collections.defaultdict(float)
        stack: List[Tuple[float, float, str]] = []
        j = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while j < len(host) and host[j][0] <= mid:
                while stack and stack[-1][1] <= host[j][0]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            by_name[stack[-1][2] if stack else "(no host region)"] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def _load(prof) -> List[dict]:
    fd, path = tempfile.mkstemp(prefix=f"h100bench_{os.getpid()}_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


class Traced:
    """The two traces of a traced run: ``device`` (the device's activity
    alone) and ``host`` (the host's too)."""

    def __init__(self, device: Trace, host: Trace):
        self.device, self.host = device, host


def profile_twice(run_calls: Callable[[], None], sync: Callable[[], None],
                  before_host: Callable[[], Callable[[], None]] = lambda: lambda: None
                  ) -> Traced:
    """``profile`` with the host too, then with the device alone, over the
    same work; ``before_host()`` sets up what only the host trace needs
    (span hooks) and returns what takes it down."""
    undo = before_host()
    try:
        host = profile(run_calls, sync, host=True)
    finally:
        undo()
    cuda = torch.cuda.is_available()
    device = profile(run_calls, sync, host=not cuda,
                     kernels=len(host.kernels) if cuda else None)
    return Traced(device, host)


def profile(run_calls: Callable[[], None], sync: Callable[[], None],
            host: bool = True, kernels: Optional[int] = None) -> Trace:
    """Trace ``run_calls`` (which wraps each call in ``CALL_SPAN``) until a
    window keeps its kernel records: with the host, its launches' records;
    with the device alone, as many records as ``kernels``, what the same
    calls left in a window that kept them. Raises after ``WINDOWS``."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    dropped: Optional[float] = None
    for _ in range(WINDOWS):
        with torch.profiler.profile(activities=activities) as prof:
            run_calls()
            sync()
        trace = Trace(_load(prof))
        if ProfilerActivity.CUDA not in activities:
            return trace
        if kernels is None:
            dropped = trace.dropped_share()
        else:
            dropped = max(0.0, 1.0 - len(trace.kernels) / kernels) if kernels else 1.0
        if dropped <= 0.01:
            return trace
        print(f"[profiler_drop] {dropped:.3f} of the kernel records lost; "
              "profiling again", file=sys.stderr)
    raise RuntimeError(f"the profiler dropped kernel records in {WINDOWS} windows "
                       f"(last: {dropped:.3f} of them)")
