"""``beam.sort_ms_per_kq``: device ms of the sort kernels (a name with
"sort" in it: the beam inserts', the caps' and the re-rank's radix and
bitonic sorts), per 1,000 queries asked."""

from annbench import tracing


def read(run):
    t = run.trace
    if t is None or not t.queries:
        return None
    us = tracing.kernel_us(t.events, lambda name: "sort" in name.lower())
    return us / 1e3 / (t.queries / 1e3) if us else None
