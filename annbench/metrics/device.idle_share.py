"""``device.idle_share``: the share of the traced window in which the device
ran no kernel, copy or set (the union of their spans in the trace)."""

from annbench import tracing


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    if hi <= lo:
        return None
    return 1.0 - tracing.busy_us(run.trace.events, lo, hi) / (hi - lo)
