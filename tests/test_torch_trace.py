"""The port's spans (``ggnn_torch/utils/spans.py:span``) under a
``torch.profiler``.

CPU cases (no JAX; a 1,024-point base, one intra-op thread):

* A row query and a fused query give the span tree ``ggnn.query`` >
  ``tile[<rows>/<tile rows>]`` > ``seed`` / ``walk`` (/ ``rerank``), a
  walk's ``graphs.live_read`` under its ``walk``, and ``ggnn.to_host``
  under ``ggnn.query``; ``query_async``'s results reach the host in one
  ``ggnn.to_host``.
* The ``tile[...]`` names are the tile plan's, in order.
* The ``graphs.live_read`` spans count what ``graphs.stats()`` counts, on
  both routes; on the graph route (static buffers without a graph on the
  CPU) so do the ``graphs.replay`` spans.
* A build gives a ``build.<phase>`` span for each entry of its phases.
* With no profiler running nothing enters a ``record_function``, and the
  answers equal those of the same query under the profiler.

Card case (marker ``cuda``; skipped without a card)::

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_trace.py

* The first call of a walk shape captures its programs inside
  ``graphs.capture`` spans, the second captures none; ``graphs.replay``
  and ``graphs.live_read`` spans count the replays and reads.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from ggnn_torch import GGNN
from ggnn_torch.query.ann import ann_query
from ggnn_torch.query.fused import fused_query, tile_plan
from ggnn_torch.utils import graphs, timing
from torch_reference import one_torch_thread  # noqa: F401

N, NQ, D, K = 1024, 300, 16, 12
CHUNK = 128
PROGRAM = ("ggnn.", "tile[", "seed", "walk", "rerank", "graphs.", "build.")


def _data(n, nq, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(nq, d)).astype(np.float32))


def _spans(prof):
    """The program's spans of a profile, in order of their start: the
    host's ranges, not their copies on the device's timeline."""
    return sorted((e for e in prof.events() if e.name.startswith(PROGRAM)
                   and e.device_type == DeviceType.CPU),
                  key=lambda e: e.time_range.start)


def _parent_span(e):
    """The innermost program span around ``e``, or None."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith(PROGRAM):
        p = p.cpu_parent
    return p


@pytest.fixture(scope="module")
def built():
    """One CPU build under the profiler (its spans kept) with its fused
    index, and a query batch."""
    base, query = _data(N, NQ, D)
    g = GGNN(device="cpu")
    g.set_base(base)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g.build(k_build=K, tau_build=0.5, refinement_iterations=0)
    g.build_fused_index()
    names = [e.name for e in _spans(prof)]
    return g, torch.from_numpy(query), names


def _query(g, q, engine, route=None):
    """One query of ``engine`` through its own function (``chunk`` rows a
    tile) on ``route``: (ids, dists)."""
    s = g._shards[0]
    if engine == "fused":
        return fused_query(q, s.fused_index, s.base_dev, 10, 0.6, 128,
                           base_sq=s.base_sq, chunk=CHUNK, route=route)
    return ann_query(q, s.base_dev, s.graph, g._cfg, 10, 0.6, 128,
                     base_sq=s.base_sq, chunk=CHUNK, route=route)


def test_span_off_is_one_shared_null_context_and_formats_only_on():
    assert timing.span("tile[%d/%d]", 1, 2) is timing.span("walk")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("tile[%d/%d]", 100, 256):
            pass
    assert [e.name for e in _spans(prof)] == ["tile[100/256]"]


@pytest.mark.parametrize("engine", ["row", "fused"])
def test_query_span_tree(built, engine):
    g, q, _ = built
    kw = {"chunk": CHUNK} if engine == "fused" else {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g.query(q.numpy(), 10, 0.6, 64, engine=engine, **kw)
    spans = _spans(prof)
    parents = {e.name: set() for e in spans}
    for e in spans:
        p = _parent_span(e)
        parents[e.name].add(p.name.split("[")[0] if p is not None else None)
    tiles = [n for n in parents if n.startswith("tile[")]
    assert [e.name for e in spans].count("ggnn.query") == 1
    assert parents.pop("ggnn.query") == {None}
    assert parents.pop("ggnn.to_host") == {"ggnn.query"}
    for t in tiles:
        assert parents.pop(t) == {"ggnn.query"}
    stages = {"seed", "walk"} | ({"rerank"} if engine == "fused" else set())
    for s in stages:
        assert parents.pop(s) == {"tile"}
    assert parents.pop("graphs.live_read") == {"walk"}
    assert parents == {}  # no other span on the CPU's eager route


def test_async_results_reach_the_host_in_one_span(built):
    """``query_async`` on one device: the submit is ``ggnn.query``, and
    ``result()`` copies inside one ``ggnn.to_host`` (``_finalize``'s), not
    one nested in another."""
    g, q, _ = built
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g.query_async(q.numpy(), 10, 0.6, 64).result()
    spans = _spans(prof)
    to_host = [e for e in spans if e.name == "ggnn.to_host"]
    assert len(to_host) == 1 and _parent_span(to_host[0]) is None
    assert [e.name for e in spans].count("ggnn.query") == 1


@pytest.mark.parametrize("engine", ["row", "fused"])
def test_tile_names_match_tile_plan(built, engine):
    g, q, _ = built
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _query(g, q, engine)
    got = [e.name for e in _spans(prof) if e.name.startswith("tile[")]
    plan = tile_plan(q.shape[0], CHUNK, "cpu")
    assert got == [f"tile[{rows}/{tile}]" for _, rows, tile in plan]
    assert len(got) == 3


@pytest.mark.parametrize("engine", ["row", "fused"])
@pytest.mark.parametrize("route", [graphs.EAGER, graphs.GRAPHS])
def test_walk_spans_count_the_graph_counters(built, engine, route):
    g, q, _ = built
    before = graphs.stats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _query(g, q, engine, route)
    after = graphs.stats()
    n = Counter(e.name for e in _spans(prof))
    assert n["graphs.live_read"] == after["live_reads"] - before["live_reads"] > 0
    assert n["graphs.replay"] == after["replays"] - before["replays"]
    assert (n["graphs.replay"] > 0) == (route is graphs.GRAPHS)
    assert n["graphs.capture"] == 0  # the CPU captures no graph


def test_build_spans_are_its_phases(built):
    g, _, names = built
    phases = g.last_build_stats["shards"][0]["phases"]
    assert "quantize" in phases and any(k.startswith("merge[") for k in phases)
    # a phase entered again (each layer's sym pass) adds to its entry
    assert {n for n in names if n.startswith("build.")} == {
        "build." + k for k in phases}


@pytest.mark.parametrize("engine", ["row", "fused"])
def test_no_record_function_without_profiler(built, engine, monkeypatch):
    g, q, _ = built
    entered = []
    enter = autograd_profiler.record_function.__enter__

    def counted(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(autograd_profiler.record_function, "__enter__", counted)
    kw = {"chunk": CHUNK} if engine == "fused" else {}
    off = g.query(q.numpy(), 10, 0.6, 64, engine=engine, **kw)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = g.query(q.numpy(), 10, 0.6, 64, engine=engine, **kw)
    assert "ggnn.query" in entered
    np.testing.assert_array_equal(off.ids, on.ids)
    np.testing.assert_array_equal(off.dists, on.dists)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["row", "fused"])
def test_card_capture_and_replay_spans(cuda_device, engine):
    base, query = _data(8192, 300, 32, seed=1)
    g = GGNN(device=cuda_device)
    g.set_base(base)
    g.build(k_build=K, tau_build=0.5, refinement_iterations=0)
    g.build_fused_index()
    q = torch.from_numpy(query).to(cuda_device)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    counts = []
    for _ in range(2):  # the first call captures, the second replays
        before = graphs.stats()
        with profile(activities=activities) as prof:
            _query(g, q, engine)
            torch.cuda.synchronize()
        after = graphs.stats()
        names = [e.name for e in _spans(prof)]
        n = Counter(names)
        for span, key in (("graphs.capture", "captures"),
                          ("graphs.replay", "replays"),
                          ("graphs.live_read", "live_reads")):
            assert n[span] == after[key] - before[key]
        counts.append(n)
        assert [t for t in names if t.startswith("tile[")] == [
            f"tile[{r}/{t}]" for _, r, t in tile_plan(300, CHUNK, cuda_device)]
    assert counts[0]["graphs.capture"] > 0
    assert counts[1]["graphs.capture"] == 0
    assert counts[1]["graphs.replay"] > 0
    g.close()
