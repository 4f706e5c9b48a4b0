"""``beam.pop_ms_per_kq``: device ms of the beam ops' pop kernel
(``beam_pop_kernel``: every walk step's pop, which updates the beam and the
visited ring in place) per 1,000 queries asked -- the trace's kernel events
whose function's name, past its return type and namespaces, starts with
the kernel's. A program without the kernel gives nothing."""

import re

from annbench import tracing

_KERNEL = re.compile(r"(?:^|[\s:])beam_pop_kernel\w*(?=[<(]|$)")


def read(run):
    t = run.trace
    if t is None or not t.queries:
        return None
    us = tracing.kernel_us(t.events, lambda name: _KERNEL.search(name) is not None)
    return us / 1e3 / (t.queries / 1e3) if us else None
