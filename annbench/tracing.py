"""Arithmetic over a ``torch.profiler`` Chrome trace of the traced calls.

The harness wraps each call into the program in a ``record_function``
span named :data:`CALL_SPAN`; the traced window runs from the first such
span's start to the last one's end. Device work is the trace's kernel,
copy and set events; a profiler range of the program (``seed``, ``walk``,
``rerank``) owns the device work whose runtime launch lies inside it,
matched by correlation id (a CUDA graph's kernels carry the correlation
id of the graph's launch). Times in the trace are microseconds.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

__all__ = ["CALL_SPAN", "DEVICE_CATS", "Trace", "breakdown", "busy_us",
           "call_window", "kernel_us", "ranges", "range_work"]

CALL_SPAN = "annbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    """A traced stretch of the window: its events, the calls and the
    queries asked in it, and the program's counters' increase over it."""

    events: list
    calls: int
    queries: int
    counters: dict = field(default_factory=dict)

    @property
    def window(self) -> tuple[float, float]:
        return call_window(self.events)


def _spans(events, cats=None, name=None):
    return sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
                  if e.get("ph") == "X"
                  and (cats is None or e.get("cat") in cats)
                  and (name is None or e.get("name") == name))


def call_window(events) -> tuple[float, float]:
    """(start, end) of the harness's call spans, or (0, 0) without any."""
    spans = _spans(events, ("user_annotation",), CALL_SPAN)
    if not spans:
        return 0.0, 0.0
    return spans[0][0], max(b for _, b in spans)


def _merged(spans, lo, hi):
    """The union of ``spans`` clipped to [lo, hi], as disjoint sorted spans."""
    out = []
    for a, b in spans:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(events, lo, hi) -> float:
    """Microseconds of [lo, hi] in which the device ran a kernel, a copy or
    a set: the union of their spans."""
    return sum(b - a for a, b in _merged(_spans(events, DEVICE_CATS), lo, hi))


def kernel_us(events, pred) -> float:
    """Summed microseconds of the kernels whose name satisfies ``pred``."""
    return sum(e.get("dur", 0.0) for e in events
               if e.get("cat") == "kernel" and pred(e.get("name", "")))


def ranges(events, name) -> list:
    """The spans of the program's profiler ranges called ``name``."""
    return _spans(events, ("user_annotation",), name)


def range_work(events, name) -> list:
    """For each range called ``name``, in order: (its span, the device
    events launched inside it, the host ops inside it)."""
    spans = ranges(events, name)
    if not spans:
        return []
    starts = [a for a, _ in spans]

    def owner(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i if i >= 0 and ts <= spans[i][1] else None

    corr, ops = {}, [[] for _ in spans]
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            i = owner(e["ts"])
            if i is not None:
                corr[e["args"]["correlation"]] = i
        elif cat == "cpu_op":
            i = owner(e["ts"])
            if i is not None:
                ops[i].append(e)
    work = [[] for _ in spans]
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            i = corr.get(e.get("args", {}).get("correlation"))
            if i is not None:
                work[i].append(e)
    return list(zip(spans, work, ops))


def breakdown(events, lo, hi, top: int = 10) -> dict:
    """The device operations that took most time in [lo, hi] and the
    longest idle gaps of the device there, each gap named by the innermost
    host operation (of the thread that made the calls) running at its
    middle: ``{"device_ops": [[name, s], ...], "idle_gaps": [[name, s], ...]}``,
    each at most ``top`` long, largest first."""
    by_op = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and lo <= e["ts"] <= hi:
            name = e.get("name", "")[:100]
            by_op[name] = by_op.get(name, 0.0) + e.get("dur", 0.0) / 1e6
    busy = _merged(_spans(events, DEVICE_CATS), lo, hi)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    tids = {e.get("tid") for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == CALL_SPAN}
    # one thread's host ops nest: sweep the gaps' middles in order with a
    # stack of the ops open there, whose top is the innermost
    host = sorted(((e["ts"], e["ts"] + e.get("dur", 0.0), e.get("name", "")[:100])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in _HOST_CATS and e.get("tid") in tids),
                  key=lambda h: (h[0], -h[1]))
    by_gap, stack, j = {}, [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "outside any host op"
        by_gap[name] = by_gap.get(name, 0.0) + (b - a) / 1e6
    return {"device_ops": sorted(([k, v] for k, v in by_op.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in by_gap.items()),
                                key=lambda kv: -kv[1])[:top]}
