"""``beam.merge_launches_per_call`` on canned kernel events: the sort
kernel's launches, matched by its function's name, per traced call; none
where the program has no such kernel."""

import pytest

from annbench import harness, registry, tracing

SORT = ("void (anonymous namespace)::beam_sort_merge_kernel<8>(float const*, "
        "long long, int const*, long long)")


def _read(names, calls=2):
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10.0 * k, "dur": 5.0}
              for k, n in enumerate(names)]
    events.append({"ph": "X", "cat": "cpu_op", "name": "beam_sort_merge_kernel",
                   "ts": 0.0, "dur": 1.0})
    run = harness.Run({}, {}, {}, trace=tracing.Trace(events, calls=calls, queries=100))
    return registry.metric_reader("beam.merge_launches_per_call")(run)


def test_counts_the_kernel_per_call():
    names = [SORT, "beam_sort_merge_kernel<2>(float const*)", SORT,
             "void (anonymous namespace)::beam_dedup_kernel<true, 12>(int const*)",
             "void at::native::radixSortKVInPlace<2, -1, 32, 32, float, long>()",
             "void other::my_beam_sort_merge_kernel_copy<8>()"]
    assert _read(names) == pytest.approx(1.5)


def test_nothing_without_the_kernel():
    assert _read(["void at::native::radixSortKVInPlace<2, -1, 32, 4, float, long>()"]) is None
    run = harness.Run({}, {}, {})
    assert registry.metric_reader("beam.merge_launches_per_call")(run) is None
