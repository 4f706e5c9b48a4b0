"""``beam.dedup_ms_per_kq``: device ms of the beam ops' dedup kernels
(``beam_dedup_kernel``, one warp a row, and ``beam_dedup_split_kernel``, a
long narrow row over a block of warps: every walk step's id dedup, alone or
fused with the compaction) per 1,000 queries asked -- the trace's kernel
events whose function's name, past its return type and namespaces, starts
with ``beam_dedup``. A program without such a kernel gives nothing."""

import re

from annbench import tracing

_KERNEL = re.compile(r"(?:^|[\s:])beam_dedup\w*(?=[<(]|$)")


def read(run):
    t = run.trace
    if t is None or not t.queries:
        return None
    us = tracing.kernel_us(t.events, lambda name: _KERNEL.search(name) is not None)
    return us / 1e3 / (t.queries / 1e3) if us else None
