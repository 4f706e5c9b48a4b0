"""The metrics' arithmetic against hand-computed values, on canned calls
and a canned trace."""

import numpy as np
import pytest

from annbench import harness, registry, tracing
from annbench.counts.approx_topk import approx_bound


def read(name, run):
    return registry.metric_reader(name)(run)


def _run(**kw):
    return harness.Run({}, {"engine_kwargs": {"num_seeds": 8}}, {}, **kw)


def test_recall_counts_every_answer_of_the_window():
    gt = np.array([[0, 1], [2, 3], [4, 5], [6, 7]])
    a = np.array([[0, 9], [3, 2]])      # hits 1, 2
    b = np.array([[5, 4], [6, 7]])      # hits 2, 2
    a2 = np.array([[0, 1], [3, 2]])     # the first call again, row 0 better: 2, 2
    d = np.zeros((2, 2), np.float32)
    calls = [(0, 2, a, d), (2, 2, b, d), (0, 2, a2, d)]
    rows, ids, dists, canon, per_call = harness._answers(calls)
    # each position's first answer whole, then the one row that differs
    assert rows.tolist() == [0, 1, 2, 3, 0]
    assert ids.tolist() == [[0, 9], [3, 2], [5, 4], [6, 7], [0, 1]]
    assert harness._recall(calls, canon, per_call, gt, 2) == pytest.approx(11 / 12)
    assert harness._recall(calls[:2], canon, per_call[:2], gt, 2) == pytest.approx(7 / 8)


def test_qps_p95_and_the_set_up_numbers():
    lat = [0.010 + 0.001 * i for i in range(40)]   # 10 .. 49 ms
    run = _run(latencies=lat, queries=400_000, window_s=0.5, recall=0.9,
               build_s=30.0, setup_s=55.0,
               phases={"merge[1->0]": 2.0, "merge[2->1]": 0.5, "sym[0]": 1.5,
                       "quantize": 9.0})
    assert read("qps", run) == pytest.approx(800_000.0)
    # nearest rank: ceil(0.95 * 40) = 38th smallest = 47 ms
    assert read("p95_call_ms", run) == pytest.approx(47.0)
    assert read("recall_at_10", run) == 0.9
    assert read("build_s", run) == 30.0 and read("setup_s", run) == 55.0
    assert read("build.merge_s", run) == 2.5 and read("build.sym_s", run) == 1.5
    assert read("device.idle_share", run) is None
    assert read("qps", _run()) is None and read("p95_call_ms", _run()) is None


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": 1,
            "args": args}


def canned_trace():
    """Two calls, 0-100 us and 100-200 us. Call one: a seed range (a
    seeding product of [256, 128] x [128, 4096] and an approx top-k kernel
    of 8 us), a walk range (a graph launch whose two kernels ran 20 and 10
    us, one of them a sort). Call two: a copy of 30 us and a sort of 10 us
    that overlaps it by 5 us."""
    dims = [[256, 128], [128, 4096]]
    return [
        _x(tracing.CALL_SPAN, "user_annotation", 0, 100),
        _x(tracing.CALL_SPAN, "user_annotation", 100, 100),
        _x("seed", "user_annotation", 5, 20),
        _x("aten::mm", "cpu_op", 6, 3, **{"Input Dims": dims}),
        _x("cudaLaunchKernel", "cuda_runtime", 10, 2, correlation=1),
        _x("approx_topk_kernel_warpILi4ELi0EE", "kernel", 12, 8, correlation=1),
        _x("walk", "user_annotation", 30, 60),
        _x("cudaGraphLaunch", "cuda_runtime", 31, 2, correlation=2),
        _x("cudaStreamSynchronize", "cuda_runtime", 34, 50),
        _x("void at::native::radixSortKVInPlace<float>", "kernel", 35, 20,
           correlation=2),
        _x("beam_dedup_kernel", "kernel", 60, 10, correlation=2),
        _x("aten::_local_scalar_dense", "cpu_op", 85, 1),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 120, 30, correlation=3),
        _x("bitonicSortKVInPlace", "kernel", 145, 10, correlation=4),
        _x("aten::_local_scalar_dense", "cpu_op", 160, 1),
        _x("aten::_local_scalar_dense", "cpu_op", 260, 1),   # outside the window
    ]


def test_idle_share_and_breakdown_on_a_canned_trace():
    t = tracing.Trace(canned_trace(), calls=2, queries=2000, counters={"live_reads": 1})
    assert t.window == (0, 200)
    # busy: 12-20, 35-55, 60-70, 120-155 -> 8 + 20 + 10 + 35 = 73 us of 200
    assert tracing.busy_us(t.events, 0, 200) == pytest.approx(73.0)
    assert read("device.idle_share", _run(trace=t)) == pytest.approx(1 - 73 / 200)
    b = tracing.breakdown(t.events, 0, 200)
    assert b["device_ops"][0] == ["Memcpy DtoH (Device -> Pageable)", pytest.approx(30e-6)]
    gaps = dict(b["idle_gaps"])
    # 0-12 (mid 6: aten::mm), 20-35 (mid 27.5: the call span), 55-60 (mid
    # 57.5: the stream sync), 70-120 (mid 95 and the call span), 155-200
    assert gaps["aten::mm"] == pytest.approx(12e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(5e-6)
    assert gaps[tracing.CALL_SPAN] == pytest.approx((15 + 50 + 45) * 1e-6)


def test_range_and_kernel_metrics_on_a_canned_trace():
    t = tracing.Trace(canned_trace(), calls=2, queries=2000, counters={"live_reads": 1})
    run = _run(trace=t)
    assert read("fused.seed_ms_per_kq", run) == pytest.approx(0.008 / 2)
    assert read("fused.walk_ms_per_kq", run) == pytest.approx(0.030 / 2)
    assert read("beam.sort_ms_per_kq", run) == pytest.approx(0.030 / 2)
    assert read("gather_dist.ms_per_kq", run) is None
    # two scalar reads in the window, one of them a live-count read
    assert read("walk.host_syncs_per_call", run) == pytest.approx(1.0)
    t.counters["live_reads"] = 6
    assert read("walk.host_syncs_per_call", run) == pytest.approx(3.0)
    bound = approx_bound(256, 4096, 8)[1]
    assert read("approx_topk_roofline", run) == pytest.approx(100 * bound / 0.008)


def test_approx_topk_byte_count_is_the_hand_sum():
    # the dot tile, both norm vectors, the [B, k] f32 distances + i32 positions
    assert approx_bound(8192, 30752, 8)[0] == (8192 * 30752 * 4 + 30752 * 4
                                               + 8192 * 4 + 8192 * 8 * 8)
    nbytes, ms, by = approx_bound(2048, 4000, 32)
    assert nbytes == 2048 * 4000 * 4 + 4000 * 4 + 2048 * 4 + 2048 * 32 * 8
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
