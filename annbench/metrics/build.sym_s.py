"""``build.sym_s``: seconds of the build's ``sym[..]`` phases (the
program's ``PhaseTimer``, host clock fenced by a device synchronise)."""


def read(run):
    s = [v for k, v in run.phases.items() if k.startswith("sym[")]
    return sum(s) if s else None
