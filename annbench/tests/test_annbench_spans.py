"""The program spans' arithmetic (``annbench/spans.py``) and the metrics
that read it, on a hand-built trace with known answers."""

import json

import pytest

from annbench import harness, registry, spans, tracing
from conftest import CHECKOUT


def read(name, run):
    return registry.metric_reader(name)(run)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _u(name, ts, dur, tid=1):
    return _x(name, "user_annotation", ts, dur, tid)


def canned_trace(program=True):
    """Two calls, 0-100 us and 100-200 us, inside the profiler's step span.
    Call one: ``ggnn.query`` 2-98 > ``tile[1808/2048]`` 5-80 > ``seed`` 6-20
    (a kernel 10-25) and ``walk`` 20-70 > ``graphs.replay`` 22-30 (a graph
    whose kernel ran 40-60), ``graphs.live_read`` 30-45, ``graphs.replay``
    45-50; then ``ggnn.to_host`` 85-95 (a copy 88-92). Call two:
    ``ggnn.query`` 102-190 > ``tile[8192/8192]`` 105-180 > ``walk`` 110-170
    > ``graphs.replay`` 110-120 (a graph whose kernel ran 115-160); then
    ``ggnn.to_host`` 182-188 (a copy 185-187). Another thread's span covers
    everything and counts for nothing. ``program=False``: the same device
    work under the call spans alone, as a program without spans gives."""
    harness_events = [
        _u("ProfilerStep#1", 0, 250),
        _u(tracing.CALL_SPAN, 0, 100),
        _u(tracing.CALL_SPAN, 100, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 7, 2, correlation=1),
        _x("void at::native::elementwise_kernel", "kernel", 10, 15, correlation=1),
        _x("cudaGraphLaunch", "cuda_runtime", 23, 2, correlation=2),
        _x("void at::native::radixSortKVInPlace<float>", "kernel", 40, 20,
           correlation=2),
        _x("cudaMemcpyAsync", "cuda_runtime", 86, 6, correlation=4),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 88, 4, correlation=4),
        _x("cudaGraphLaunch", "cuda_runtime", 111, 2, correlation=3),
        _x("gather_dist_kernel", "kernel", 115, 45, correlation=3),
        _x("cudaMemcpyAsync", "cuda_runtime", 183, 4, correlation=5),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 185, 2, correlation=5),
        _u("ggnn.query", 0, 200, tid=2),
    ]
    if not program:
        return harness_events
    return harness_events + [
        _u("ggnn.query", 2, 96), _u("tile[1808/2048]", 5, 75), _u("seed", 6, 14),
        _u("walk", 20, 50), _u("graphs.replay", 22, 8),
        _u("graphs.live_read", 30, 15), _u("graphs.replay", 45, 5),
        _u("ggnn.to_host", 85, 10),
        _u("ggnn.query", 102, 88), _u("tile[8192/8192]", 105, 75),
        _u("walk", 110, 60), _u("graphs.replay", 110, 10),
        _u("ggnn.to_host", 182, 6),
    ]


def _run(events, **kw):
    t = tracing.Trace(events, calls=2, queries=10_000)
    return harness.Run({}, {}, {}, trace=t, **kw)


# idle stretches 0-10, 25-40, 60-88, 92-115, 160-185, 187-200 (114 us)
IDLE = {spans.HARNESS: 2 + 4 + 10, "ggnn.query": 3 + 5 + 3 + 3 + 2 + 2,
        "tile[1808/2048]": 1 + 10, "tile[8192/8192]": 5 + 10, "seed": 4,
        "walk": 10 + 10, "graphs.replay": 5 + 5, "graphs.live_read": 10,
        "ggnn.to_host": 3 + 3 + 3 + 1}


def test_program_spans_leave_out_the_harness_the_profiler_and_other_threads():
    names = [n for _, _, n in spans.program_spans(canned_trace())]
    assert names[:3] == ["ggnn.query", "tile[1808/2048]", "seed"]
    assert len(names) == 13
    assert spans.program_spans(canned_trace(program=False)) == []


def test_idle_gaps_are_the_complement_of_the_device_work():
    events = canned_trace()
    assert spans.idle_gaps(events, 0, 200) == [
        (0, 10), (25, 40), (60, 88), (92, 115), (160, 185), (187, 200)]
    assert sum(b - a for a, b in spans.idle_gaps(events, 0, 200)) == pytest.approx(
        200 - tracing.busy_us(events, 0, 200))


def test_idle_by_span_splits_gaps_exactly_at_span_boundaries():
    got = spans.idle_by_span(canned_trace(), 0, 200)
    assert got == pytest.approx(IDLE)
    assert sum(got.values()) == pytest.approx(114)
    # the gap 25-40 is split between a replay (25-30) and a read (30-45)
    assert spans.idle_by_span(canned_trace(), 25, 40) == pytest.approx(
        {"graphs.replay": 5, "graphs.live_read": 10})
    # a program without spans has nothing to put the idle time down to
    assert spans.idle_by_span(canned_trace(program=False), 0, 200) == {}


def test_self_time_and_tile_rows():
    events = canned_trace()
    # call one: 96 - (75 + 10); call two: 88 - (75 + 6)
    assert spans.self_us(events, "ggnn.query", 0, 200) == (pytest.approx(11 + 7), 2)
    assert spans.self_us(events, "walk", 0, 200) == (
        pytest.approx((50 - 8 - 15 - 5) + (60 - 10)), 2)
    assert spans.self_us(events, "ggnn.query", 0, 100) == (pytest.approx(11), 1)
    assert spans.tile_rows(events, 0, 200) == (10_000, 10_240)
    assert spans.tile_rows(events, 100, 200) == (8192, 8192)


def test_the_five_readers_on_the_canned_trace():
    run = _run(canned_trace(), phases={"quantize": 9.25, "merge[1->0]": 2.0})
    assert read("api.host_ms_per_call", run) == pytest.approx(0.018 / 2)
    # two replays in call one, one in call two
    assert read("walk.replays_per_call", run) == 3 / 2
    # the kernels launched inside the walks: 20 + 45 us for 10,000 queries
    assert read("row.walk_ms_per_kq", run) == pytest.approx(0.065 / 10)
    assert read("tile.pad_share", run) == pytest.approx(240 / 10_240)
    assert read("build.quantize_s", run) == 9.25


def test_the_readers_find_nothing_without_spans():
    run = _run(canned_trace(program=False), phases={"merge[1->0]": 2.0})
    for name in ("api.host_ms_per_call", "walk.replays_per_call",
                 "row.walk_ms_per_kq", "tile.pad_share", "build.quantize_s"):
        assert read(name, run) is None, name
    untraced = harness.Run({}, {}, {})
    assert read("api.host_ms_per_call", untraced) is None
    assert read("tile.pad_share", untraced) is None


@pytest.mark.parametrize("cell, row", [("sift1m-fused-b10k", False),
                                       ("deep1m-row-b10k", True)])
def test_both_cells_report_the_span_metrics(cell, row):
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in registry.cell_metrics(bench, cell, True)]
    new = ["api.host_ms_per_call", "walk.replays_per_call",
           "tile.pad_share", "build.quantize_s"] + (["row.walk_ms_per_kq"] if row else [])
    assert set(new) <= set(names)
