"""``gather_dist.ms_per_kq``: device ms of the ``gather_dist`` kernel (the
walks' f32 gather + distance), per 1,000 queries asked."""

from annbench import tracing


def read(run):
    t = run.trace
    if t is None or not t.queries:
        return None
    us = tracing.kernel_us(t.events, lambda name: "gather_dist" in name)
    return us / 1e3 / (t.queries / 1e3) if us else None
