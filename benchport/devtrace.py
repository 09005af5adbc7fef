"""The traced window: device activity from ``torch.profiler`` and host
spans recorded by this harness around the calls into each layer.

Host spans are wrappers that the harness puts around functions of the
port for the traced run only (``HostSpans.install``); they time with
``time.perf_counter_ns``.  The profiler's own clock is tied to it by two
markers that the harness thread records at the window's opening and
close.  The summary gives the device's busy seconds (the union of its
kernels, copies and sets), the kernels' summed time, the device
operations that took most time, and the idle gaps of the device, each
named by the innermost host span that was open at its middle.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

OPEN_MARK = "benchport.window_open"
CLOSE_MARK = "benchport.window_close"
NO_SPAN = "no request in the server"


class HostSpans:
    """Timed wrappers around named callables (``(owner, attribute,
    label)``), collected as (label, start_ns, end_ns) in one list."""

    def __init__(self):
        self.spans: list = []
        self._saved: list = []

    def _wrap(self, fn, label):
        spans = self.spans

        def timed(*a, **k):
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **k)
            finally:
                spans.append((label, t0, time.perf_counter_ns(), threading.get_ident()))

        timed.__wrapped__ = fn
        return timed

    def install(self, targets) -> None:
        for owner, attr, label in targets:
            fn = getattr(owner, attr, None) if owner is not None else None
            if fn is None:
                continue
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, label))

    def remove(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


def _ev_start_end_ns(ev):
    s = ev.start_ns()
    return s, s + ev.duration_ns()


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type()).upper()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _name_gaps(gaps, spans) -> dict:
    """Seconds of idle gap by the innermost host span open at each gap's
    middle (the open span that started last), over ``spans`` sorted by
    start: a sweep with a heap keyed by start."""
    import heapq

    by_gap = defaultdict(int)
    heap: list = []
    j = 0
    for g0, g1 in gaps:  # in increasing order
        mid = (g0 + g1) // 2
        while j < len(spans) and spans[j][0] <= mid:
            heapq.heappush(heap, (-spans[j][0], spans[j][1], spans[j][2]))
            j += 1
        while heap and heap[0][1] < mid:  # ended: it covers no later middle
            heapq.heappop(heap)
        by_gap[heap[0][2] if heap else NO_SPAN] += g1 - g0
    return by_gap


class DeviceTrace:
    """``torch.profiler`` over the window, with CPU and CUDA activity."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.marks: dict = {}

    def start(self) -> None:
        self.prof.start()

    def mark(self, name: str) -> None:
        from torch.profiler import record_function

        with record_function(name):
            self.marks[name] = time.perf_counter_ns()

    def stop(self) -> None:
        self.prof.stop()

    def summary(self, host_spans) -> dict:
        events = list(self.prof.profiler.kineto_results.events())
        marks = {}
        device = []
        for ev in events:
            name = ev.name()
            if name in (OPEN_MARK, CLOSE_MARK) and not _is_device(ev):
                marks[name] = _ev_start_end_ns(ev)[0]
            elif _is_device(ev):
                s, e = _ev_start_end_ns(ev)
                device.append((name, s, e))
        if OPEN_MARK not in marks or CLOSE_MARK not in marks:
            raise RuntimeError("the profiler recorded no window markers")
        lo, hi = marks[OPEN_MARK], marks[CLOSE_MARK]
        # Profiler time of a perf_counter_ns reading.
        offset = lo - self.marks[OPEN_MARK]
        inside = [(n, max(s, lo), min(e, hi)) for n, s, e in device if e > lo and s < hi]
        busy = _merge([(s, e) for _, s, e in inside])
        busy_ns = sum(e - s for s, e in busy)
        by_name = defaultdict(int)
        kernel_ns = 0
        for n, s, e in inside:
            by_name[n] += e - s
            if not n.startswith(("Memcpy", "Memset")):
                kernel_ns += e - s
        gaps = []
        prev = lo
        for s, e in busy + [[hi, hi]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        by_gap = _name_gaps(gaps, sorted(
            (s0 + offset, s1 + offset, label) for label, s0, s1, _tid in host_spans
        ))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        top_gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
        return {
            "window_s": (hi - lo) / 1e9,
            "busy_s": busy_ns / 1e9,
            "kernel_s": kernel_ns / 1e9,
            "device_ops": [[n[:96], ns / 1e9] for n, ns in top],
            "idle_gaps": [[n, ns / 1e9] for n, ns in top_gaps],
            "open_ns": self.marks[OPEN_MARK],
            "close_ns": self.marks.get(CLOSE_MARK),
        }
