"""``walk.replays_per_call``: walk programs launched per traced call, the
count of the program's ``graphs.replay`` spans (one a replay, as
``graphs.stats()["replays"]`` counts them). A count, so the profiler does
not inflate it; a program without spans gives nothing."""

from annbench import spans


def read(run):
    t = run.trace
    if t is None or not t.calls:
        return None
    lo, hi = t.window
    names = [name for a, b, name in spans.program_spans(t.events)
             if lo <= a and b <= hi]
    if "ggnn.query" not in names:
        return None
    return names.count("graphs.replay") / t.calls
