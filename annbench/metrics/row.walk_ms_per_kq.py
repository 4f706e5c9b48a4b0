"""``row.walk_ms_per_kq``: device ms of the work launched inside the row
engine's ``walk`` spans (its uncapped first steps and the walk programs),
per 1,000 queries asked (padding rows are not queries)."""

from annbench import tracing


def read(run):
    t = run.trace
    if t is None or not t.queries:
        return None
    work = tracing.range_work(t.events, "walk")
    us = sum(e.get("dur", 0.0) for _, dev, _ in work for e in dev)
    return us / 1e3 / (t.queries / 1e3) if us else None
