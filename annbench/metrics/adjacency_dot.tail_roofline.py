"""``adjacency_dot.tail_roofline``: the tail adjacency kernels' share of
their bytes bound, in %: the least time their traced launches could take
(``counts/adjacency_dot.py`` over the anchors they fetched) over their
device time.

The anchors come from the program's own count, which it keeps only while
a profiler records, so over the traced calls alone:
``ggnn_torch.ops.adjacency.fetched_anchors()`` by kernel variant, those of
the configuration's layout with ``_tail`` (a program without tail kernels
has no such key, and gives nothing). Each launch's query rows are its
grid's first dimension in the trace. ``CR`` and ``D`` are the
configuration's: D code bytes a row, unpadded, whatever the kernel
reads."""

import re

from annbench.counts.adjacency_dot import adjacency_bytes, bytes_ms

TAIL = re.compile(r"(?:^|[\s:])adjacency_dot_(u8|int4)_tail_(?:t\d+|wide)\b")


def _fetched(layout):
    """Anchors the tail kernels of ``layout`` fetched, or None without the
    program's count."""
    from ggnn_torch.ops import adjacency

    counts = getattr(adjacency, "fetched_anchors", None)
    if counts is None:
        return None
    n = sum(v for key, v in counts().items() if key[0] == f"{layout}_tail")
    return n or None


def read(run):
    t = run.trace
    if t is None:
        return None
    cfg = run.config
    nibbles = int(cfg.get("bits", 8)) == 4
    layout = "int4" if nibbles else "u8"
    launches = []
    for e in t.events:
        m = TAIL.search(e.get("name", "")) if e.get("cat") == "kernel" else None
        if m and m.group(1) == layout:
            launches.append(e)
    kernel_ms = sum(e.get("dur", 0.0) for e in launches) / 1e3
    if not kernel_ms:
        return None
    anchors = _fetched(layout)
    if anchors is None:
        return None
    rows = sum(int((e.get("args", {}).get("grid") or [0])[0]) for e in launches)
    CR = int(cfg["k_build"]) * int(cfg.get("group", 1)) // (2 if nibbles else 1)
    nbytes = adjacency_bytes(anchors, rows, int(cfg["pops_per_iter"]), CR,
                             int(cfg["dim"]), nibbles)
    return 100.0 * bytes_ms(nbytes) / kernel_ms
