"""``beam.dedup_ms_per_kq`` on canned kernel events: the dedup kernels'
device ms (the one-warp row's and the split narrow row's), matched by
their functions' names, per 1,000 queries asked; none where the program
has no such kernel."""

import pytest

from annbench import harness, registry, tracing

ONE_WARP = ("void (anonymous namespace)::beam_dedup_kernel<false, 1>(int const*, "
            "long long, unsigned char const*, long long)")
SPLIT = ("void (anonymous namespace)::beam_dedup_split_kernel<false>(int const*, "
         "long long)")


def _read(names, queries=2000):
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10.0 * k, "dur": 5.0}
              for k, n in enumerate(names)]
    events.append({"ph": "X", "cat": "cpu_op", "name": "beam_dedup_kernel",
                   "ts": 0.0, "dur": 100.0})
    run = harness.Run({}, {}, {}, trace=tracing.Trace(events, calls=2,
                                                      queries=queries))
    return registry.metric_reader("beam.dedup_ms_per_kq")(run)


def test_sums_both_rows_per_thousand_queries():
    names = [ONE_WARP, SPLIT, "beam_dedup_kernel<true, 12>",
             ONE_WARP.replace("<false, 1>", "<true, 3>"),
             "void (anonymous namespace)::beam_pop_kernel(float*, long long)",
             "void at::native::elementwise_kernel<128, 2>(int, beam_dedup_kernel)",
             "void other::my_beam_dedup_kernel_copy()"]
    # four launches of 5 us over 2 thousand queries
    assert _read(names) == pytest.approx(4 * 5.0 / 1e3 / 2)


def test_nothing_without_the_kernel():
    assert _read(["void at::native::unrolled_elementwise_kernel<direct_copy>()",
                  "void (anonymous namespace)::beam_sort_merge_kernel<8>()"]) is None
    assert registry.metric_reader("beam.dedup_ms_per_kq")(harness.Run({}, {}, {})) is None
