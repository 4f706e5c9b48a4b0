"""``tile.pad_share``: padding rows over planned tile rows in the traced
calls, from the names of the program's ``tile[<rows>/<tile rows>]``
spans."""

from annbench import spans


def read(run):
    t = run.trace
    if t is None:
        return None
    rows, planned = spans.tile_rows(t.events, *t.window)
    return (planned - rows) / planned if planned else None
