"""``beam.merge_launches_per_call``: launches of the beam ops' sort kernel
(``beam_sort_merge_kernel``: ``beam_insert``'s sorted merge and the fused
step's cap cut) per traced call -- the trace's kernel events whose
function's name, past its return type and namespaces, starts with the
kernel's. A count, which the profiler does not inflate; a program without
the kernel gives nothing."""

import re

_KERNEL = re.compile(r"(?:^|[\s:])beam_sort_merge_kernel\b")


def read(run):
    t = run.trace
    if t is None or not t.calls:
        return None
    n = sum(1 for e in t.events if e.get("cat") == "kernel"
            and _KERNEL.search(e.get("name", "")))
    return n / t.calls if n else None
