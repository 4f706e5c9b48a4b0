"""``gather_dist.wide_ms_per_kq``: device ms of the ``gather_dist`` kernel's
multi-slab instances (``gather_dist_kernel<Q, 4, ...>``: four 128-wide slabs
of query values a pass, rows above 128 dims; the fused re-rank at D = 960),
per 1,000 queries asked; a run without them gives nothing."""

import re

from annbench import tracing

WIDE = re.compile(r"gather_dist_kernel<\s*\d+\s*,\s*4\s*,")


def read(run):
    t = run.trace
    if t is None or not t.queries:
        return None
    us = tracing.kernel_us(t.events, lambda name: WIDE.search(name) is not None)
    return us / 1e3 / (t.queries / 1e3) if us else None
