"""The program's spans on the profiler's clock.

:func:`span` marks a stretch of the program as a ``torch.profiler`` range
(a ``user_annotation`` in the trace, on the clock of the kernels, copies
and runtime calls) while a profiler records on the calling thread; with
none recording it costs one flag check. No span opens inside a walk's step
or a graph capture. This module imports nothing of the package, so every
layer (the walk programs of ``graphs`` included) may use it.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch
from torch.profiler import record_function

__all__ = ["recording", "span"]

_OFF = nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` records on this thread (not while it
    only warms up)."""
    return torch.autograd._profiler_enabled()


def span(name: str, *args):
    """The profiler range ``name`` (``name % args`` where values are given,
    formatted only then) while a ``torch.profiler`` records on this thread;
    otherwise one shared context that does nothing."""
    if not recording():
        return _OFF
    return record_function(name % args if args else name)
