"""``api.host_ms_per_call``: per traced call, the milliseconds inside the
program's ``ggnn.query`` span outside every program span nested in it
(the API's own host time: argument checks, the shard loop, the merge)."""

from annbench import spans


def read(run):
    t = run.trace
    if t is None or not t.calls:
        return None
    us, n = spans.self_us(t.events, "ggnn.query", *t.window)
    return us / 1e3 / t.calls if n else None
