"""``build_s``: the one ``GGNN.build`` of the set-up, host clock to a device
synchronise (the kernels are built before it; the fused index is not in
it)."""


def read(run):
    return run.build_s
