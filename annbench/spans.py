"""Arithmetic over the program's own spans in a traced run's Chrome trace.

While a profiler records, ``ggnn_torch`` marks its layers as profiler
ranges (``ggnn_torch/utils/spans.py:span``): ``ggnn.query`` (one API
call), ``ggnn.to_host``, ``tile[<rows>/<tile rows>]``, ``seed``, ``walk``,
``rerank``, ``graphs.replay``, ``graphs.capture``, ``graphs.live_read`` and
``build.<phase>``. In the trace each is a ``user_annotation`` of the
thread that made the calls. A *program span* is such an event other than
the harness's :data:`tracing.CALL_SPAN` and the profiler's own
``ProfilerStep#<n>``. A program without spans gives every function here
nothing to count. Times in the trace are microseconds.
"""

from __future__ import annotations

import bisect
import re

from annbench import tracing

__all__ = ["HARNESS", "idle_by_span", "idle_gaps", "program_spans",
           "self_us", "tile_rows"]

# what a device-idle microsecond is put down to where no program span is open
HARNESS = "harness"
_TILE = re.compile(r"tile\[(\d+)/(\d+)\]")


def program_spans(events) -> list:
    """(start, end, name) of every program span on the thread(s) that made
    the calls, sorted by start, the outer of two that start together
    first."""
    tids = {e.get("tid") for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == tracing.CALL_SPAN}
    return sorted(((e["ts"], e["ts"] + e.get("dur", 0.0), e.get("name", ""))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e.get("tid") in tids
                   and e.get("name") != tracing.CALL_SPAN
                   and not e.get("name", "").startswith("ProfilerStep#")),
                  key=lambda s: (s[0], -s[1]))


def idle_gaps(events, lo, hi) -> list:
    """The stretches of [lo, hi] in which the device ran no kernel, copy or
    set, in order."""
    busy = tracing._merged(tracing._spans(events, tracing.DEVICE_CATS), lo, hi)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    return gaps


def idle_by_span(events, lo, hi) -> dict:
    """Each device-idle microsecond of [lo, hi], put down to the innermost
    program span open at that instant (the latest started of those open),
    or to :data:`HARNESS` where none is: ``{name: us}``. A gap that crosses
    a span's boundary is split exactly there. A program without spans gives
    ``{}``."""
    spans = program_spans(events)
    if not spans:
        return {}
    gaps = idle_gaps(events, lo, hi)
    cuts = sorted({lo, hi} | {t for a, b, _ in spans for t in (a, b) if lo < t < hi})
    out, stack, j, g = {}, [], 0, 0
    for t0, t1 in zip(cuts, cuts[1:]):
        while j < len(spans) and spans[j][0] <= t0:
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t0:
            stack.pop()
        while g < len(gaps) and gaps[g][1] <= t0:
            g += 1
        idle, k = 0.0, g
        while k < len(gaps) and gaps[k][0] < t1:
            idle += min(t1, gaps[k][1]) - max(t0, gaps[k][0])
            k += 1
        if idle > 0:
            name = stack[-1][2] if stack else HARNESS
            out[name] = out.get(name, 0.0) + idle
    return out


def self_us(events, name, lo, hi) -> tuple[float, int]:
    """(summed microseconds, count) of the program spans called ``name``
    that lie in [lo, hi], each counted outside every other program span
    nested in it: the span's self time."""
    spans = program_spans(events)
    starts = [a for a, _, _ in spans]
    total, n = 0.0, 0
    for i, (a, b, nm) in enumerate(spans):
        if nm != name or a < lo or b > hi:
            continue
        inner = [(x, y) for x, y, _ in spans[i + 1 : bisect.bisect_right(starts, b)]
                 if y <= b]
        total += (b - a) - sum(y - x for x, y in tracing._merged(inner, a, b))
        n += 1
    return total, n


def tile_rows(events, lo, hi) -> tuple[int, int]:
    """(query rows, planned tile rows) summed over the ``tile[...]`` spans
    that lie in [lo, hi]; the difference is padding."""
    rows = planned = 0
    for a, b, name in program_spans(events):
        m = _TILE.fullmatch(name)
        if m and lo <= a and b <= hi:
            rows += int(m.group(1))
            planned += int(m.group(2))
    return rows, planned
