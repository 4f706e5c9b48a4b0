"""``adjacency_dot.tail_ms_per_kq``: device ms of the adjacency kernel's
tail instances (``adjacency_dot_<u8|int4>_tail_t<lanes>`` and
``..._tail_wide``: code rows whose width is a multiple of 4 bytes but not
of 16, read as 4-byte words; every fused step and merge at D = 100), per
1,000 queries asked; a run without them gives nothing."""

import re

from annbench import tracing

TAIL = re.compile(r"(?:^|[\s:])adjacency_dot_(u8|int4)_tail_(?:t\d+|wide)\b")


def read(run):
    t = run.trace
    if t is None or not t.queries:
        return None
    us = tracing.kernel_us(t.events, lambda name: TAIL.search(name) is not None)
    return us / 1e3 / (t.queries / 1e3) if us else None
