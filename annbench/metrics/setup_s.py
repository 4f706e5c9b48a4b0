"""``setup_s``: from the start of the process to the window's start: imports,
data, kernel libraries (their compilation in a checkout's first run), the
build, the fused index and the warm-up cycle."""


def read(run):
    return run.setup_s
