"""``p95_call_ms``: the 95th percentile (nearest rank) of every call of the
window, from submit to host results, in milliseconds."""

import math


def read(run):
    lat = sorted(run.latencies)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
