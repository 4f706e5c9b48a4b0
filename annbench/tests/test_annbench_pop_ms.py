"""``beam.pop_ms_per_kq`` on canned kernel events: the pop kernel's device
ms, matched by its function's name, per 1,000 queries asked; none where
the program has no such kernel."""

import pytest

from annbench import harness, registry, tracing

POP = ("void (anonymous namespace)::beam_pop_kernel(float*, long long, int*, "
       "long long)")


def _read(names, queries=2000):
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10.0 * k, "dur": 5.0}
              for k, n in enumerate(names)]
    events.append({"ph": "X", "cat": "cpu_op", "name": "beam_pop_kernel",
                   "ts": 0.0, "dur": 100.0})
    run = harness.Run({}, {}, {}, trace=tracing.Trace(events, calls=2,
                                                      queries=queries))
    return registry.metric_reader("beam.pop_ms_per_kq")(run)


def test_sums_the_kernel_per_thousand_queries():
    names = [POP, "beam_pop_kernel", POP,
             "void (anonymous namespace)::beam_sort_merge_kernel<8>(float const*)",
             "void at::native::elementwise_kernel<128, 2>(int, beam_pop_kernel)",
             "void other::my_beam_pop_kernel_copy()"]
    # three launches of 5 us over 2 thousand queries
    assert _read(names) == pytest.approx(3 * 5.0 / 1e3 / 2)


def test_nothing_without_the_kernel():
    assert _read(["void at::native::unrolled_elementwise_kernel<direct_copy>()"]) is None
    assert registry.metric_reader("beam.pop_ms_per_kq")(harness.Run({}, {}, {})) is None
