"""``recall_at_10``: over every query answered in the window, the share of
its exact 10 nearest base points (the reference's) that were returned."""


def read(run):
    return run.recall
