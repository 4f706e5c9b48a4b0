"""``walk.host_syncs_per_call``: host reads of a device value per traced
call: the walks' live-count reads (``graphs.stats()["live_reads"]``) and
the other reads of a device scalar (``aten::_local_scalar_dense``) in the
trace. Each live-count read is itself one of those trace events, so their
union is the larger of the two counts."""


def read(run):
    t = run.trace
    if t is None or not t.calls:
        return None
    lo, hi = t.window
    scalar = sum(1 for e in t.events if e.get("name") == "aten::_local_scalar_dense"
                 and lo <= e.get("ts", lo - 1) <= hi)
    return max(scalar, t.counters.get("live_reads", 0)) / t.calls
