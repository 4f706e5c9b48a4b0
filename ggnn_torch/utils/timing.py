"""Wall-clock phase timing with us/point throughput logs.

The analog of the reference's cudaEvent ``time_launcher`` instrumentation
(graph_construction.cu:54-77): phases are timed with host clocks around
device work that is fenced by a device synchronise at the end of the phase
(``graphs.synchronize``: never during another thread's graph capture), and
reported in the same "N queries -> X us/query" format.

Every phase of a :class:`PhaseTimer` is also the span ``build.<phase>``
(:func:`ggnn_torch.utils.spans.span`, re-exported here), so a profiled
build lines up with its kernels.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from ggnn_torch.utils import graphs
from ggnn_torch.utils.logging import vlog
from ggnn_torch.utils.spans import span

__all__ = ["PhaseTimer", "span"]


class PhaseTimer:
    """Accumulates named phase durations; logs us/point at VLOG level.

    ``device``: the device whose queued work each phase waits for before its
    clock stops (a CUDA device is synchronised; the CPU needs no fence)."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.phases: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str, n: int = 0):
        with span("build." + name):
            start = time.perf_counter()
            try:
                yield
            finally:
                graphs.synchronize(self.device)
                elapsed = time.perf_counter() - start
                self.phases[name] = self.phases.get(name, 0.0) + elapsed
                if n:
                    vlog(
                        2,
                        "%s: %.3f ms for %d queries -> %.3f us/query",
                        name,
                        elapsed * 1e3,
                        n,
                        elapsed * 1e6 / n,
                    )
                else:
                    vlog(2, "%s: %.3f ms", name, elapsed * 1e3)

    def total(self) -> float:
        return sum(self.phases.values())
