"""Walks as device programs: the port's counterpart of ``jax.jit`` +
``lax.while_loop``.

The JAX package compiles a walk into one device program: each compaction
phase of the fused query is a ``lax.while_loop`` (``run_phase`` in
``ggnn_tpu/query/fused.py``), and so are ``fused_best_first``, the row walk
(``ggnn_tpu/ops/traverse.py``) and the build's merge chunks. Here a walk
is a *step* ``step(carry, consts) -> (carry, live)`` over a tuple of
tensors -- the carry, the beam state -- and per-row constants -- the
queries, their norms, the slack -- and :func:`run_steps` drives it until
the pop budget is spent or no more than ``floor`` rows are live.

Two routes run that loop:

* **graphs** (the default on a CUDA device, but for the sym pass's walk):
  ``STEPS_PER_REPLAY`` steps are captured once into a ``torch.cuda.CUDAGraph``
  over static buffers and replayed; the host reads the live-row count after
  each replay that leaves some of the step budget. Rows walk independently
  and a row whose pop comes up empty stays unchanged by later steps, so the
  extra steps a replay may run past the point where the per-step loop
  would have stopped change no result. A failed capture or
  replay raises; nothing falls back to the eager loop. On the CPU the same
  programs step their static buffers without a graph (tests only: it holds
  the chunked check and the buffers' bookkeeping to the eager loop).
* **eager** (the CPU's, and the plain version the graphs are held
  against): the steps run one by one and the live count is read after
  every step but the budget's last.

A *program* holds the static buffers of one walk shape and one graph per
step count. It is cached under the step's static arguments, the shapes
and dtypes of the carry and the constants, and the ``data_ptr``, shape and
dtype of every other tensor the step reads (``reads``: the index or the
graph layer, the base): a graph reads those by address, so a program is
only found again while tensors of those shapes lie at those addresses --
and then it computes on whatever they hold. A program keeps no reference
to the tensors it reads: when one of them is freed, the programs that read
it are released with it (at once, or -- if that thread was inside this
module -- at the next walk), and :func:`drop` releases them earlier.
Programs whose first read tensor is the same share one memory pool and one
lock, held for a whole walk: their graphs never replay at the same time,
while two threads walking two shards use two pools. A pool's memory goes
back to the device (``cudaFree``), as the reference's jitted programs
leave none behind: once the last program that used it is gone (dropped,
its read tensor freed, or evicted), its graphs are destroyed and one
``torch.cuda.empty_cache`` returns its segments -- not while any thread
captures (then at the next walk or :func:`drop`), and not before the
dead pools of a device hold more than ``CACHE_SHARE`` of the card
(counted as the memory each pool took while its graphs were captured):
emptying the cache costs the eager work after it its allocations again,
which the build's many small walks would pay for little memory. A walk
whose step makes intermediates of a large share of the card (the sym
walk's chunks) asks for ``fresh_pool``: the cache is emptied after the
eager warm-up step before its pool's first capture, so that the pool
takes the memory that step left cached, not memory beside it (its
uncapped first step is a program of its own in the same pool).
Captures take one
global lock and the ``thread_local`` capture mode, so that another thread's
allocations during a capture do not break it; a device-wide synchronise
(which CUDA refuses while any stream of the device captures) waits for that
lock (:func:`synchronize`). The warm-up step before a program's first
capture runs on the capturing thread's side stream (kernel libraries are
built and the cuBLAS workspace is made there, never inside the capture).

Under ``torch.profiler`` a program's launch is the span ``graphs.replay``,
its capture ``graphs.capture`` (around the capture, never inside it) and
each live-count read ``graphs.live_read`` (``utils/spans.py:span``): they
count what :func:`stats` counts.
"""

from __future__ import annotations

import enum
import threading
import weakref
from collections import OrderedDict, deque
from contextlib import contextmanager

import torch

from ggnn_torch.utils.spans import span

__all__ = [
    "EAGER",
    "GRAPHS",
    "MAX_PROGRAMS",
    "STEPS_PER_REPLAY",
    "Route",
    "clear",
    "count_launch",
    "drop",
    "entries",
    "pool_bytes",
    "resolve",
    "run_steps",
    "stats",
    "synchronize",
    "thread_captures",
    "thread_live_reads",
]

# steps per replay: a fused query tile at its operating point runs ~6 steps
STEPS_PER_REPLAY = 4
# programs kept at once; the least recently used goes first
MAX_PROGRAMS = 64
# the share of a card that dead pools may hold before their memory goes
# back to the device, and that the cache must hold before a fresh pool's
# first capture empties it
CACHE_SHARE = 1 / 64


class Route(enum.Enum):
    """How a walk's loop runs."""

    GRAPHS = "graphs"  # captured programs, one live-count read per replay
    EAGER = "eager"  # one step and one live-count read at a time


GRAPHS, EAGER = Route.GRAPHS, Route.EAGER


def resolve(route: Route | None, device) -> Route:
    """The route a walk on ``device`` takes: the given one, else graphs on a
    CUDA device and the eager loop elsewhere."""
    if route is None:
        return GRAPHS if torch.device(device).type == "cuda" else EAGER
    return Route(route)


class _Pool:
    """A memory pool shared by the programs that read one tensor, and the
    lock their walks hold."""

    def __init__(self, device: torch.device):
        self.device = device
        self.handle = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self.lock = threading.RLock()
        self.users = 0
        self.captured = False
        self.nbytes = 0  # what the allocator reserved while its graphs were captured


_lock = threading.Lock()  # guards the tables below
_capture_lock = threading.Lock()
_programs: OrderedDict = OrderedDict()  # key -> _Program, oldest first
_pools: dict = {}  # (device, data_ptr) -> _Pool
_watched: dict = {}  # id(read tensor) -> its (device, data_ptr)
_dead: deque = deque()  # (device, data_ptr) of read tensors freed since
_released: list = []  # (device, weak reference, bytes) of unlisted pools
_stats = {"captures": 0, "replays": 0, "live_reads": 0, "releases": 0}
_tls = threading.local()


@contextmanager
def _holding(lock):
    """Hold ``lock``; meanwhile a read tensor freed on this thread only
    queues the release of its programs (see :func:`_freed`)."""
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        with lock:
            yield
    finally:
        _tls.depth -= 1


def _bump(key: str) -> None:
    with _holding(_lock):
        _stats[key] += 1


def count_launch(fn, *args) -> None:
    """Account one kernel launch: ``fn(*args)`` now, or -- while this thread
    captures a graph, which launches nothing -- once per replay of it."""
    recording = getattr(_tls, "recording", None)
    if recording is not None:
        recording.append((fn, args))
    else:
        fn(*args)


def synchronize(device) -> None:
    """``torch.cuda.synchronize(device)`` outside any capture: CUDA refuses
    a device-wide synchronise while another thread captures a graph on the
    device, and that capture breaks. No-op on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        with _holding(_capture_lock):
            torch.cuda.synchronize(device)


def thread_captures() -> int:
    """Graphs captured by the calling thread so far."""
    return getattr(_tls, "captures", 0)


def thread_live_reads() -> int:
    """Live-count reads made by the calling thread so far."""
    return getattr(_tls, "live_reads", 0)


def _read_live(count: torch.Tensor) -> int:
    """One live-count read: the host waits for ``count``."""
    with span("graphs.live_read"):
        n = int(count)
    _tls.live_reads = thread_live_reads() + 1
    _bump("live_reads")
    return n


def _side_stream(device: torch.device):
    streams = getattr(_tls, "streams", None)
    if streams is None:
        streams = _tls.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device=device)
    return streams[device]


def _end_quietly(graph) -> None:
    """End a capture that failed part way; the step's own error is the one
    to raise."""
    try:
        graph.capture_end()
    except Exception:
        pass


class _Program:
    """Static buffers of one walk shape and its graphs, by step count. It
    holds neither the step nor the tensors the step reads: the caller
    passes the step to every replay."""

    def __init__(self, carry, consts, live, reads, pool, fresh_pool):
        self.kind = type(carry)
        self.carry = tuple(torch.empty_like(t) for t in carry)
        self.consts = tuple(torch.empty_like(t) for t in consts)
        self.live = torch.empty_like(live)
        self.count = torch.zeros((), dtype=torch.int64, device=live.device)
        self.reads = frozenset(reads)
        self.pool = pool
        self.graphs: dict = {}  # steps -> (CUDAGraph, launches per replay)
        self.warm = False
        self.fresh_pool = fresh_pool

    @property
    def device(self) -> torch.device:
        return self.count.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (*self.carry, *self.consts, self.live))

    def load(self, carry, consts) -> None:
        for dst, src in zip(self.carry + self.consts, tuple(carry) + tuple(consts)):
            dst.copy_(src)

    def unload(self):
        return (self.kind(*(t.clone() for t in self.carry)), self.live.clone())

    def _steps(self, step, n: int) -> None:
        """``n`` steps from the static carry back into it, the live rows and
        their count into their buffers."""
        carry = self.kind(*self.carry)
        for _ in range(n):
            carry, live = step(carry, self.consts)
        for dst, src in zip(self.carry, carry):
            dst.copy_(src)
        self.live.copy_(live)
        self.count.copy_(live.sum())

    def _capture(self, step, n: int) -> None:
        dev = self.device
        with span("graphs.capture"), _holding(_capture_lock):
            side = _side_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                if not self.warm:
                    # one real step on copies of the loaded state: libraries
                    # and workspaces come into being outside the capture
                    step(self.kind(*(t.clone() for t in self.carry)), self.consts)
                    self.warm = True
                if (self.fresh_pool and not self.pool.captured
                        and torch.cuda.memory_reserved(dev)
                        - torch.cuda.memory_allocated(dev) > _share_bytes(dev)):
                    # what the warm-up step (and the walk's eager work
                    # before it) freed goes back to the device, for the
                    # pool to take rather than lie cached beside it
                    torch.cuda.empty_cache()
                self.pool.captured = True
                reserved = torch.cuda.memory_reserved(dev)
                graph = torch.cuda.CUDAGraph()
                recorded: list = []
                _tls.recording = recorded
                try:
                    graph.capture_begin(pool=self.pool.handle,
                                        capture_error_mode="thread_local")
                    try:
                        self._steps(step, n)
                    except BaseException:
                        _end_quietly(graph)
                        raise
                    graph.capture_end()
                finally:
                    _tls.recording = None
                self.pool.nbytes += max(0, torch.cuda.memory_reserved(dev) - reserved)
            torch.cuda.current_stream(dev).wait_stream(side)
        self.graphs[n] = (graph, tuple(recorded))
        _tls.captures = thread_captures() + 1
        _bump("captures")

    def replay(self, step, n: int) -> None:
        """Run ``n`` steps of ``step`` (capturing their graph first if
        needed; on the CPU without a graph); the live-row count is left in
        ``count``."""
        cuda = self.device.type == "cuda"
        if cuda and n not in self.graphs:
            self._capture(step, n)
        with span("graphs.replay"):
            if not cuda:
                self._steps(step, n)
            else:
                graph, launches = self.graphs[n]
                graph.replay()
                for fn, args in launches:
                    fn(*args)
            _bump("replays")


def _key(name, carry, consts, reads):
    def sig(t):
        return (tuple(t.shape), t.dtype, str(t.device))

    return (name, tuple(sig(t) for t in carry), tuple(sig(t) for t in consts),
            tuple((t.data_ptr(), *sig(t)) for t in reads))


def _ptrs(tensors):
    return {(str(t.device), t.data_ptr()) for t in tensors
            if isinstance(t, torch.Tensor)}


def _freed(tid: int, ptr) -> None:
    """A read tensor was freed: release the programs that read it -- now,
    unless this thread is inside this module (holding one of its locks, or
    capturing), and then at the next walk."""
    _watched.pop(tid, None)
    _dead.append(ptr)
    if not getattr(_tls, "depth", 0):
        _reap()


def _watch(tensors) -> None:
    """Have each tensor's death call :func:`_freed` (under ``_lock``)."""
    for t in tensors:
        if id(t) not in _watched:
            ptr = (str(t.device), t.data_ptr())
            _watched[id(t)] = ptr
            weakref.finalize(t, _freed, id(t), ptr).atexit = False


def _forget(doomed) -> int:
    """Unlist the programs ``doomed(program)`` picks and the pools nobody
    uses any more; they are freed once no walk holds them, and the pools'
    memory goes back to the device then (:func:`_release`)."""
    with _holding(_lock):
        keys = [k for k, p in _programs.items() if doomed(p)]
        progs = [_programs.pop(k) for k in keys]
        _unpool(progs)
    n = len(progs)
    del progs  # the programs, and their graphs, die here unless a walk holds one
    _release()
    return n


def _unpool(progs) -> None:
    for p in progs:  # under _lock
        p.pool.users -= 1
        if p.pool.users == 0:
            for k, v in list(_pools.items()):
                if v is p.pool:
                    del _pools[k]
            if p.pool.captured:
                _released.append((p.pool.device, weakref.ref(p.pool),
                                  p.pool.nbytes))


def _share_bytes(device) -> float:
    """``CACHE_SHARE`` of the card's memory."""
    return CACHE_SHARE * torch.cuda.get_device_properties(device).total_memory


def _release() -> None:
    """Return the segments of unlisted pools to the device: once every
    program that used such a pool is gone -- its graphs destroyed, which
    hands the pool back to the allocator -- and the dead pools of a device
    hold more than ``CACHE_SHARE`` of the card, one ``empty_cache`` frees
    them all. Not while any thread captures a graph (CUDA refuses it, and
    the capture breaks), nor inside this module's capture: then the next
    walk, :func:`drop` or :func:`stats` does it."""
    dead: dict = {}
    with _holding(_lock):
        for d, r, nbytes in _released:
            if r() is None:
                dead[d] = dead.get(d, 0) + nbytes
    if not any(nbytes > _share_bytes(d) for d, nbytes in dead.items()):
        return
    if (getattr(_tls, "depth", 0) or torch.cuda.is_current_stream_capturing()
            or not _capture_lock.acquire(blocking=False)):
        return
    try:
        with _holding(_lock):
            _released[:] = [e for e in _released if e[1]() is not None]
            _stats["releases"] += 1
        torch.cuda.empty_cache()
    finally:
        _capture_lock.release()


def _reap() -> None:
    """Release the programs that read tensors freed since the last reap,
    and the memory of pools whose last program has gone since."""
    dead = set()
    while _dead:
        dead.add(_dead.popleft())
    if dead:
        _forget(lambda p: bool(p.reads & dead))
    else:
        _release()


def _program(name, carry, consts, live, reads, fresh_pool):
    """The cached program of this key, made if missing."""
    reads = tuple(t for t in reads if t is not None)
    key = _key(name, carry, consts, reads)
    with _holding(_lock):
        prog = _programs.get(key)
        if prog is not None:
            _programs.move_to_end(key)
            return prog
        dev = live.device
        owner = (str(dev), reads[0].data_ptr() if reads else 0)
        pool = _pools.get(owner)
        if pool is None:
            pool = _pools[owner] = _Pool(dev)
        pool.users += 1
        prog = _Program(carry, consts, live, _ptrs(reads), pool, fresh_pool)
        _watch(reads)
        _programs[key] = prog
        # bound the cache, oldest first; a walk that holds an unlisted
        # program finishes with it
        evicted = [_programs.popitem(last=False)[1]
                   for _ in range(len(_programs) - MAX_PROGRAMS)]
        _unpool(evicted)
    return prog


def run_steps(step, carry, consts, live, *, it: int, steps: int, live_n: int,
              floor: int, route: Route, name=(), reads=(), fresh_pool=False):
    """Step the walk while ``it < steps`` and more than ``floor`` rows are
    live: on the graphs route ``STEPS_PER_REPLAY`` steps between two reads
    of the live count, on the eager route one. No read follows the step
    that spends the budget: it would decide nothing.

    ``step(carry, consts) -> (carry, live [B] bool)`` must be free of host
    syncs and read no tensor other than its arguments and ``reads`` (plus
    Python constants, which belong in ``name``). ``live_n``: the live count
    on entry. ``fresh_pool``: the step's intermediates are a large share
    of the card, so the cache is emptied before its pool's first capture
    (see the module's notes). Returns ``(carry, live, it, live_n)`` after
    the last step, ``live_n`` as last read (stale once ``it == steps``;
    ``live`` is not); the carry is the caller's own (never a program's
    buffers)."""
    if not (it < steps and live_n > floor):
        return carry, live, it, live_n
    if route is EAGER:
        while it < steps and live_n > floor:
            carry, live = step(carry, consts)
            it += 1
            if it < steps:
                live_n = _read_live(live.sum())
        return carry, live, it, live_n
    _reap()
    prog = _program(name, carry, consts, live, reads, fresh_pool)
    with _holding(prog.pool.lock):
        prog.load(carry, consts)
        while it < steps and live_n > floor:
            n = min(STEPS_PER_REPLAY, steps - it)
            prog.replay(step, n)
            it += n
            if it < steps:
                live_n = _read_live(prog.count)
        carry, live = prog.unload()
    del prog  # an evicted program dies here, and its pool's memory with it
    _release()
    return carry, live, it, live_n


def drop(*tensors) -> int:
    """Release every program that reads one of these tensors (before they
    are freed or replaced, to free the pools early). Returns how many were
    released."""
    _reap()
    ptrs = _ptrs(tensors)
    return _forget(lambda p: bool(p.reads & ptrs))


def clear() -> None:
    """Release every program."""
    _reap()
    _forget(lambda p: True)


def stats() -> dict:
    """Counters since import (graphs captured, replays, live-count reads,
    releases of dead pools' memory) and what is cached now: programs,
    graphs, their static buffers' bytes, the pools and the dead pools whose
    memory waits for a release."""
    _reap()
    with _holding(_lock):
        progs = list(_programs.values())
        out = dict(_stats)
        out["pools"] = len(_pools)
        out["pools_waiting"] = len(_released)
    out["programs"] = len(progs)
    out["graphs"] = sum(len(p.graphs) for p in progs)
    out["buffer_bytes"] = sum(p.nbytes() for p in progs)
    return out


def entries() -> list:
    """The cached programs' read sets: (device, data_ptr) pairs."""
    _reap()
    with _holding(_lock):
        return [p.reads for p in _programs.values()]


def pool_bytes() -> int | None:
    """Device bytes the graphs' pools hold now (the allocator's segments of
    those pools), or None where the allocator's snapshot does not name a
    segment's pool."""
    _reap()
    with _holding(_lock):
        handles = {tuple(p.handle) for p in _pools.values() if p.handle is not None}
    if not handles:
        return 0
    total = 0
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is None:
            return None
        if tuple(pid) in handles:
            total += seg["total_size"]
    return total
