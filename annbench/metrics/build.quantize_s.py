"""``build.quantize_s``: seconds of the build's ``quantize`` phase, the fit
of the u8 quantizer and the encoding of the base (the program's
``PhaseTimer``, host clock fenced by a device synchronise; in a profile
the span ``build.quantize``)."""


def read(run):
    return run.phases.get("quantize")
