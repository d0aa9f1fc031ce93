"""The traced window: ``torch.profiler`` over a fixed number of batches or
steps, and the reduction of its trace to what the per-layer metrics read.

* busy seconds: the union of the intervals in which a kernel, a copy or a
  memset ran on the device;
* a span's device seconds: the kernels whose launch (the runtime call
  with the same correlation id) lies inside the span, on the span's
  thread, summed;
* the breakdown: the device operations that took most time, and the idle
  gaps summed by what the host's main thread was doing during them.

Spans are ``record_function`` ranges the benchmark puts around the calls
it wraps (``core/wraps.py``) and around each batch or step.
"""

from __future__ import annotations

import bisect
import collections
import json
import pathlib
import re
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


class Trace:
    def __init__(self, events: list, window_s: float, iters: int):
        self.window_s = window_s
        self.iters = iters
        device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.kernels = [e for e in device if e["cat"] == "kernel"]
        self.intervals = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
        self.busy_s = sum(b - a for a, b in self.intervals) * 1e-6
        self._kernel_us = collections.defaultdict(float)
        for e in self.kernels:
            self._kernel_us[e["args"].get("correlation")] += e["dur"]
        launches = collections.defaultdict(list)
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["tid"]].append((e["ts"], e["args"]["correlation"]))
        self._launches = {tid: sorted(v) for tid, v in launches.items()}
        self.spans = collections.defaultdict(list)
        self.host = collections.defaultdict(list)
        for e in events:
            if e.get("cat") == "user_annotation":
                self.spans[e["name"]].append(e)
            if e.get("cat") in HOST_CATS and "dur" in e:
                self.host[e["tid"]].append(e)

    def span_device_s(self, label: str) -> float:
        """Device seconds of the kernels launched inside the spans ``label``."""
        total = 0.0
        for span in self.spans.get(label, ()):
            launches = self._launches.get(span["tid"], [])
            lo = bisect.bisect_left(launches, (span["ts"], -1))
            hi = bisect.bisect_right(launches, (span["ts"] + span["dur"], float("inf")))
            total += sum(self._kernel_us.get(corr, 0.0) for _, corr in launches[lo:hi])
        return total * 1e-6

    def breakdown(self, main_span: str, top: int = 10) -> dict:
        ops = collections.defaultdict(float)
        for e in self.kernels:
            ops[short_name(e["name"])] += e["dur"] * 1e-6
        gaps = collections.defaultdict(float)
        mains = self.spans.get(main_span)
        if mains and self.intervals:
            host = sorted(self.host.get(mains[0]["tid"], []), key=lambda e: (e["ts"], -e["dur"]))
            mids = [((a + b) / 2, (b - a) * 1e-6) for (_, a), (b, _) in zip(self.intervals, self.intervals[1:])]
            for name, seconds in _innermost(host, mids):
                gaps[name] += seconds
        return {"device_ops": _top(ops, top), "idle_gaps": _top(gaps, top)}


def _top(d: dict, n: int) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _innermost(host: list, points: list):
    """For each (time, weight) in time order, the name of the innermost
    host event (nested, sorted by start) running then, by one sweep."""
    stack, i = [], 0
    for t, weight in points:
        while i < len(host) and host[i]["ts"] <= t:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < host[i]["ts"]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        yield (stack[-1]["name"] if stack else "host outside any op"), weight


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short_name(name: str) -> str:
    name = re.sub(r"^void |\(anonymous namespace\)::|at::native::|cutlass::", "", name)
    return name[:120]


def traced(loop, iters: int, path: pathlib.Path) -> Trace:
    """Run ``loop(iters)`` (which ends on a synchronise) under the profiler
    and reduce its trace; the trace file is written to ``path`` (inside the
    checkout) and removed once read."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(iters)
        window_s = time.perf_counter() - t0
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return Trace(events, window_s, iters)
