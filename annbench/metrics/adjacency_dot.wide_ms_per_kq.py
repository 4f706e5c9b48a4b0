"""``adjacency_dot.wide_ms_per_kq``: device ms of the adjacency kernel's
wide instances (``adjacency_dot_u8_wide``, ``adjacency_dot_int4_wide``:
code rows above 512 bytes, every fused step at D = 960), per 1,000 queries
asked; a run without them gives nothing."""

import re

from annbench import tracing

WIDE = re.compile(r"(?:^|[\s:])adjacency_dot_(u8|int4)_wide\b")


def read(run):
    t = run.trace
    if t is None or not t.queries:
        return None
    us = tracing.kernel_us(t.events, lambda name: WIDE.search(name) is not None)
    return us / 1e3 / (t.queries / 1e3) if us else None
