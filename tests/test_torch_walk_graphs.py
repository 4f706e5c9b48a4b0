"""The walks' loops as device programs (``ggnn_torch/utils/graphs.py``).

On the card a walk replays CUDA graphs of ``S`` steps and reads the live
count once per replay; the plain version steps eagerly and reads it after
every step. CPU cases (no JAX; 1,024 points, one intra-op thread):

* The chunked check -- S steps between two reads of the live count, what
  the card replays -- run by the graph route's programs on the CPU (their
  static buffers, copy-in and copy-out, without a graph) gives the per-step
  loop's ids and distances bit for bit: for the fused query, for
  ``fused_best_first_compacted`` (the build merge's walk, on the merge's
  adjacency layout) and for the row walk, with S in {1, 3, 4},
  ``compact_levels`` in {0, 2} and both distance measures.
* The program cache: a new ``data_ptr`` or a new shape makes a new entry,
  the same call finds its entry, ``drop`` releases it, and so does freeing
  a tensor it reads; an evicted shard, a replaced index and a closed
  ``GGNN`` leave no entry behind; shards that rotate through the device
  are copied into the buffers evicted shards left, whose programs serve
  every shard that passes through.
* The tile plan: every batch size walks one of a few tile shapes, and a
  padded tile returns what a full one does.
* ``q . zero`` computed once per tile and selected with the rows equals the
  per-step product on the selected rows.
* A launch made while a graph is captured is counted once per replay.
* No live-count read follows the step that spends the budget, on either
  route.

Card cases (marker ``cuda``; skipped without a card)::

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_walk_graphs.py

* The graph route equals the eager route bit for bit on a small base: fused
  u8, group 2 and int4, the row walk, cosine, a uint8 base and k_query=6000;
  the kernel's launches rise by the replays' count. So does a layer-0 sym
  pass in walk mode (new graph and counters) on the graph route, with two
  captures for its one walk shape (the uncapped first step, the capped
  steps); no program is left reading its graph.
* A rotated run through graphs equals the all-resident one, and its
  second call captures fewer graphs than its first.
* A GGNN that goes out of scope gives back its device memory, the graphs'
  pools included; a walk's pool goes back to the device once the tensor it
  reads is freed, with no ``empty_cache`` call in the test (on the CPU:
  the release's bookkeeping, deferred while a capture holds the lock and
  while the dead pools hold little).
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from ggnn_torch import GGNN, DistanceMeasure
from ggnn_torch.build.sym import sym_pass
from ggnn_torch.ops import adjacency
from ggnn_torch.ops.beam import beam_init, beam_insert
from ggnn_torch.ops.distance import dist_block, squared_norms
from ggnn_torch.ops.topk import smallest_k_positions
from ggnn_torch.query import fused as fused_mod
from ggnn_torch.query.ann import ann_query
from ggnn_torch.query.fused import (
    build_fused_index,
    encode_u8,
    fused_best_first_compacted,
    fused_query,
    make_adjacency,
    quantizer_for,
)
from ggnn_torch.utils import graphs
from torch_reference import one_torch_thread  # noqa: F401

N, NQ, D, K = 1024, 600, 32, 12
E, C = DistanceMeasure.Euclidean, DistanceMeasure.Cosine
MEASURES = [E, C]


def _data(n, nq, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(nq, d)).astype(np.float32))


@pytest.fixture(scope="module")
def built():
    """One CPU build per measure with its fused index."""
    base, query = _data(N, NQ, D)
    out = {}
    for m in MEASURES:
        g = GGNN(device="cpu")
        g.set_base(base)
        g.build(k_build=K, tau_build=0.5, refinement_iterations=0, measure=m)
        g.build_fused_index()
        out[m] = g
    return base, query, out


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def _fused(g, query, m, route, levels=2):
    shard = g._shards[0]
    return fused_query(torch.from_numpy(query), shard.fused_index,
                       shard.base_dev, 10, 0.6, 64, m, pops_per_iter=4,
                       compact_levels=levels, route=route)


def _row(g, query, m, route):
    shard = g._shards[0]
    return ann_query(torch.from_numpy(query), shard.base_dev, shard.graph,
                     g._cfg, 10, 0.6, 64, m, route=route)


@pytest.mark.parametrize("measure", MEASURES, ids=["euclidean", "cosine"])
@pytest.mark.parametrize("levels", [0, 2])
@pytest.mark.parametrize("S", [1, 3, 4])
def test_fused_query_chunked_equals_per_step(built, S, levels, measure,
                                             monkeypatch):
    _, query, gs = built
    g = gs[measure]
    want = _fused(g, query, measure, graphs.EAGER, levels)
    monkeypatch.setattr(graphs, "STEPS_PER_REPLAY", S)
    got = _fused(g, query, measure, graphs.GRAPHS, levels)
    _same(got, want)


def _merge_walk_inputs(g, base, measure):
    """The build merge's final leg on layer 0: its adjacency layout and a
    beam seeded from the layer-1 representatives, as ``merge.py`` makes it."""
    shard = g._shards[0]
    graph, cfg = shard.graph, g._cfg
    b = torch.from_numpy(base)
    scale, zero = quantizer_for(b)
    codes, x_hat_sq = encode_u8(b, scale, zero)
    adj = make_adjacency(codes, x_hat_sq, graph.neighbors[0], scale, zero)
    q, q_sq = b, squared_norms(b)
    reps = graph.translation[1].long()
    seed_d, pos = smallest_k_positions(
        dist_block(q, b[reps], measure, q_sq=q_sq, c_sq=q_sq[reps]), 8)
    nn1 = float(graph.nn1_stats[0])
    xi = nn1 * nn1 * 0.25 if measure == E else nn1 * 0.5
    width, vis = cfg.merge_beam_geometry()
    state = beam_insert(beam_init(N, width, xi, vis), reps.to(torch.int32)[pos],
                        seed_d, criteria=torch.full((N,), float("inf")))
    return state, q, q_sq, adj


@pytest.mark.parametrize("measure", MEASURES, ids=["euclidean", "cosine"])
@pytest.mark.parametrize("levels", [0, 2])
@pytest.mark.parametrize("S", [1, 3, 4])
def test_merge_walk_chunked_equals_per_step(built, S, levels, measure,
                                            monkeypatch):
    base, _, gs = built
    state, q, q_sq, adj = _merge_walk_inputs(gs[measure], base, measure)
    kw = dict(pops_per_iter=8, compact_levels=levels)
    want = fused_best_first_compacted(state, q, q_sq, adj, measure, 200, K + 1,
                                      route=graphs.EAGER, **kw)
    monkeypatch.setattr(graphs, "STEPS_PER_REPLAY", S)
    got = fused_best_first_compacted(state, q, q_sq, adj, measure, 200, K + 1,
                                     route=graphs.GRAPHS, **kw)
    _same(got, want)


@pytest.mark.parametrize("measure", MEASURES, ids=["euclidean", "cosine"])
@pytest.mark.parametrize("S", [1, 3, 4])
def test_row_walk_chunked_equals_per_step(built, S, measure, monkeypatch):
    _, query, gs = built
    g = gs[measure]
    want = _row(g, query, measure, graphs.EAGER)
    monkeypatch.setattr(graphs, "STEPS_PER_REPLAY", S)
    got = _row(g, query, measure, graphs.GRAPHS)
    _same(got, want)


@pytest.mark.parametrize("measure", MEASURES, ids=["euclidean", "cosine"])
def test_programs_equal_eager(built, measure):
    """The graph route's static buffers, run on the CPU without a graph:
    copy-in, replays of S steps and of the remainder on one buffer set,
    copy-out between compaction phases."""
    base, query, gs = built
    g = gs[measure]
    route = graphs.GRAPHS
    _same(_fused(g, query, measure, route), _fused(g, query, measure, graphs.EAGER))
    _same(_row(g, query, measure, route), _row(g, query, measure, graphs.EAGER))
    state, q, q_sq, adj = _merge_walk_inputs(g, base, measure)
    _same(fused_best_first_compacted(state, q, q_sq, adj, measure, 200, K + 1,
                                     route=route),
          fused_best_first_compacted(state, q, q_sq, adj, measure, 200, K + 1,
                                     route=graphs.EAGER))


def test_program_cache_key(built):
    """A new data_ptr or a new shape is a new entry; the same call finds its
    entry; dropping the index releases its entries."""
    _, query, gs = built
    g = gs[E]
    graphs.clear()
    route = graphs.GRAPHS
    index, base = g._shards[0].fused_index, g._shards[0].base_dev

    def call(idx, q):
        return fused_query(torch.from_numpy(q), idx, base, 10, 0.6, 64,
                           pops_per_iter=4, compact_levels=0, route=route)

    a = call(index, query)
    n0 = graphs.stats()["programs"]
    assert n0 == 1
    _same(call(index, query), a)
    assert graphs.stats()["programs"] == n0  # found again
    clone = type(index)(*(t.clone() for t in index))
    _same(call(clone, query), a)
    assert graphs.stats()["programs"] == n0 + 1  # other data_ptrs
    call(index, query[:300])
    assert graphs.stats()["programs"] == n0 + 2  # another shape
    assert graphs.drop(*index) == 2
    assert graphs.stats()["programs"] == 1
    assert graphs.drop(*clone) == 1
    assert graphs.stats()["programs"] == 0 and graphs.entries() == []


def test_freed_tensors_release_their_programs(built):
    """A program holds none of the tensors it reads: freeing one of them
    releases the programs that read it, and nothing else."""
    _, query, gs = built
    g = gs[E]
    graphs.clear()
    index, base = g._shards[0].fused_index, g._shards[0].base_dev
    clone = type(index)(*(t.clone() for t in index))
    for idx in (index, clone):
        fused_query(torch.from_numpy(query), idx, base, 10, 0.6, 64,
                    pops_per_iter=4, compact_levels=0, route=graphs.GRAPHS)
    assert graphs.stats()["programs"] == 2
    del clone, idx
    assert graphs.stats()["programs"] == 1
    assert all(r <= _tensor_ptrs(g) for r in graphs.entries())
    graphs.clear()


def test_dead_pools_memory_goes_back_once(built, monkeypatch):
    """A pool whose last program is gone has its memory emptied from the
    allocator's cache once: not while a capture holds the capture lock
    (then at the next reap), not while the dead pools hold little (then
    once they hold more), and not for a pool that never captured. On the
    CPU's programs, whose pools are marked captured, 100 bytes each, as the
    card's captures mark them; ``empty_cache`` counted, not run, and the
    card's share given."""
    _, query, gs = built
    g = gs[E]
    graphs.clear()
    calls, share = [], [50]
    monkeypatch.setattr(graphs.torch.cuda, "empty_cache", lambda: calls.append(1))
    monkeypatch.setattr(graphs.torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(graphs, "_share_bytes", lambda device: share[0])
    index, base = g._shards[0].fused_index, g._shards[0].base_dev
    a, b, c = (type(index)(*(t.clone() for t in index)) for _ in range(3))
    for idx in (a, b, c):
        fused_query(torch.from_numpy(query), idx, base, 10, 0.6, 64,
                    pops_per_iter=4, compact_levels=0, route=graphs.GRAPHS)
    del idx
    assert graphs.stats()["pools"] == 3
    for t in (a.blocks, b.blocks):
        graphs._pools[("cpu", t.data_ptr())].captured = True
        graphs._pools[("cpu", t.data_ptr())].nbytes = 100
    releases = graphs.stats()["releases"]
    graphs.drop(*c)
    assert calls == []  # it never captured: no pool memory to give back
    with graphs._capture_lock:  # as while another thread captures
        graphs.drop(*a)
        assert calls == [] and graphs.stats()["pools_waiting"] == 1
    share[0] = 150  # the dead pool holds little: its memory waits
    assert graphs.stats()["pools_waiting"] == 1 and calls == []
    share[0] = 50
    assert graphs.stats()["pools_waiting"] == 0 and calls == [1]
    del b  # freed: its program is released, and its pool's memory once
    assert calls == [1, 1]
    assert graphs.stats()["releases"] - releases == 2
    assert graphs.stats()["pools"] == 0
    graphs.clear()
    assert calls == [1, 1]


def _tensor_ptrs(g):
    out = set()
    for s in g._shards:
        ts = list(s.fused_index or ()) + [s.base_dev, s.base_sq]
        if s.graph is not None:
            ts += [*s.graph.neighbors, *s.graph.translation]
        out |= {(str(t.device), t.data_ptr()) for t in ts if t is not None}
    return out


def test_dropped_shards_leave_no_entry(monkeypatch):
    """Two shards rotating through one device slot, walked through
    programs: after every call each entry reads only resident tensors --
    the evicted shard's, the replaced index's and, after ``close``, every
    entry are gone."""
    monkeypatch.setattr(graphs, "resolve", lambda route, device: route or graphs.GRAPHS)
    graphs.clear()
    base, query = _data(1024, 100, 16, seed=3)
    g = GGNN(device="cpu")
    g.set_base(base)
    g.set_shard_size(512)
    g.set_max_device_shards(1)
    g.build(k_build=8, tau_build=0.5, refinement_iterations=0)
    assert graphs.stats()["programs"] == 0  # each merge layer released its own
    g.build_fused_index()
    for engine in ("fused", "row"):
        g.query(query, 10, 0.6, 32, engine=engine)
        assert g.tier_stats["evictions"] > 0
        assert graphs.stats()["programs"] > 0
        assert all(r <= _tensor_ptrs(g) for r in graphs.entries())
    g.build_fused_index(group=2)
    assert all(r <= _tensor_ptrs(g) for r in graphs.entries())
    g.close()
    assert graphs.entries() == []


def test_rotation_reuses_slots(monkeypatch):
    """Four shards through two sets of device buffers, walked through
    programs: a staged shard's walked tensors are its buffers, the second
    call finds every program the first made (the buffers' addresses), and
    the ids equal the all-resident run's."""
    monkeypatch.setattr(graphs, "resolve", lambda route, device: route or graphs.GRAPHS)
    graphs.clear()
    base, query = _data(2048, 100, 16, seed=4)
    g = GGNN(device="cpu")
    g.set_base(base)
    g.set_shard_size(512)
    g.set_max_device_shards(2)
    g.build(k_build=8, tau_build=0.5, refinement_iterations=0)
    g.build_fused_index()
    rotated = {}
    for engine in ("fused", "row"):
        first = g.query(query, 10, 0.6, 32, engine=engine)
        made = sorted(map(sorted, graphs.entries()))
        resident = [s for s in g._shards if s.resident]
        assert len(resident) == 2 and all(s.buffers is not None for s in resident)
        for s in resident:
            assert all(t is s.buffers[k] for k, t in s.walked().items())
        second = g.query(query, 10, 0.6, 32, engine=engine)
        assert sorted(map(sorted, graphs.entries())) == made
        np.testing.assert_array_equal(first.ids, second.ids)
        rotated[engine] = first.ids
    g.set_max_device_shards(4)
    for engine, ids in rotated.items():
        np.testing.assert_array_equal(
            g.query(query, 10, 0.6, 32, engine=engine).ids, ids)
    g.close()


def test_tile_plan_bounds_shapes():
    """Tiles of ``chunk`` rows, the last padded to a power of two of at
    least 256 rows: a few shapes serve every batch size."""
    assert fused_mod.tile_plan(10_000, 8192) == [(0, 8192, 8192),
                                                 (8192, 1808, 2048)]
    assert fused_mod.tile_plan(600, 8192) == [(0, 600, 1024)]
    assert fused_mod.tile_plan(17, 8192) == [(0, 17, 256)]
    assert fused_mod.tile_plan(3000, 1000) == [(0, 1000, 1000), (1000, 1000, 1000),
                                               (2000, 1000, 1000)]
    assert fused_mod.tile_plan(10_000, 8192, "cpu") == [(0, 8192, 8192),
                                                        (8192, 1808, 1808)]
    shapes = {t for q in range(1, 40_000, 37)
              for _, _, t in fused_mod.tile_plan(q, 8192)}
    assert shapes == {256, 512, 1024, 2048, 4096, 8192}


@pytest.mark.parametrize("measure", MEASURES, ids=["euclidean", "cosine"])
def test_padded_tile_equals_full_tile(built, measure, monkeypatch):
    """600 queries walk a 1,024-row tile whose padding rows start dead (as
    on the card): each query's ids and dists equal those it gets among
    1,024 real ones."""
    monkeypatch.setattr(fused_mod, "_padded", lambda device: True)
    _, _, gs = built
    g = gs[measure]
    _, more = _data(N, 1024, D, seed=5)
    full = [_fused(g, more, measure, graphs.EAGER), _row(g, more, measure, graphs.EAGER)]
    part = [_fused(g, more[:600], measure, graphs.EAGER),
            _row(g, more[:600], measure, graphs.EAGER)]
    for f, p in zip(full, part):
        _same([t[:600] for t in f], p)


def test_zero_dots_hoisted_per_tile(built):
    """``q . zero`` of the whole tile, selected with the rows as compaction
    selects them, equals the product on the selected rows alone -- the
    distances of a step are unchanged by the hoist."""
    _, query, gs = built
    index = gs[E]._shards[0].fused_index
    q = torch.from_numpy(query)
    q_sq = torch.sum(q * q, dim=-1)
    sel = torch.arange(0, NQ, 3)
    tile = fused_mod._zero_dots(q, index)
    np.testing.assert_array_equal(tile[sel].numpy(),
                                  fused_mod._zero_dots(q[sel], index).numpy())
    anchors = index.rep_ids[:4].expand(sel.shape[0], 4).contiguous()
    for m in MEASURES:
        _same(fused_mod._code_dists(q[sel], q_sq[sel], anchors, index, m,
                                    tile[sel]),
              fused_mod._code_dists(q[sel], q_sq[sel], anchors, index, m))


def test_launch_counted_per_replay():
    calls = []
    graphs.count_launch(calls.append, 1)
    assert calls == [1]
    graphs._tls.recording = rec = []
    try:
        graphs.count_launch(calls.append, 2)
    finally:
        graphs._tls.recording = None
    assert calls == [1] and rec == [(calls.append, (2,))]


class _Count(NamedTuple):
    x: torch.Tensor


@pytest.mark.parametrize("route, S, reads", [
    (graphs.EAGER, 4, 4), (graphs.GRAPHS, 4, 1), (graphs.GRAPHS, 5, 0)])
def test_no_read_once_the_budget_is_spent(route, S, reads, monkeypatch):
    """A walk of 5 steps whose rows all stay live: the eager route reads
    the live count after each of its first 4 steps, graphs of 4 steps after
    the first replay only, one replay of 5 steps never; all run 5 steps."""
    monkeypatch.setattr(graphs, "STEPS_PER_REPLAY", S)
    inc = torch.arange(3)

    def step(c, k):
        return _Count(c.x + k[0]), torch.ones(3, dtype=torch.bool)

    before = graphs.thread_live_reads()
    carry, live, it, live_n = graphs.run_steps(
        step, _Count(torch.zeros(3, dtype=torch.int64)), (inc,),
        torch.ones(3, dtype=torch.bool), it=0, steps=5, live_n=3, floor=0,
        route=route, name=("budget",), reads=(inc,))
    assert graphs.thread_live_reads() - before == reads
    assert it == 5 and live_n == 3 and bool(live.all())
    assert torch.equal(carry.x, 5 * inc)


# --- on the card ------------------------------------------------------------

NC, NQC, DC, KC = 4096, 1000, 128, 24


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sift_like(n, nq, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(16, DC)).astype(np.float32) / 4.0

    def sample(m):
        z = rng.normal(size=(m, 16)).astype(np.float32)
        x = z @ w * 40.0 + 128.0 + rng.normal(0, 4, size=(m, DC)).astype(np.float32)
        return np.clip(x, 0, 255).astype(np.float32)

    return sample(n), sample(nq)


@pytest.fixture(scope="module")
def card(cuda_device):
    base, query = _sift_like(NC, NQC)
    out = {}
    for label, b, m in (("f32", base, E), ("cosine", base, C),
                        ("uint8", np.rint(base).astype(np.uint8), E)):
        g = GGNN(device=cuda_device)
        g.set_base(b)
        g.build(k_build=KC, tau_build=0.5, refinement_iterations=1, measure=m)
        out[label] = (g, torch.from_numpy(query).to(cuda_device), m)
    return out


def _launches_through_graphs(fn):
    before = adjacency.launches
    res = fn()
    torch.cuda.synchronize()
    return res, adjacency.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("label, group, bits", [
    ("f32", 1, 8), ("f32", 2, 8), ("f32", 1, 4), ("cosine", 1, 8),
    ("uint8", 1, 8)])
def test_card_fused_graph_route_equals_eager(card, label, group, bits):
    g, q, m = card[label]
    shard = g._shards[0]
    index = build_fused_index(shard.base_dev, shard.graph, g._cfg, group=group,
                              bits=bits)
    kw = dict(num_seeds=8, rerank=16, width=32, cap=32, pops_per_iter=4,
              base_sq=shard.base_sq)
    eager = fused_query(q, index, shard.base_dev, 10, 0.64, 24, m,
                        route=graphs.EAGER, **kw)
    captured = graphs.stats()["captures"]
    for _ in range(2):  # the first call captures, the second replays
        got, n = _launches_through_graphs(lambda: fused_query(
            q, index, shard.base_dev, 10, 0.64, 24, m, **kw))
        _same([t.cpu() for t in got], [t.cpu() for t in eager])
        assert n > 0
    assert graphs.stats()["captures"] > captured
    graphs.drop(*index)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["f32", "cosine", "uint8"])
def test_card_row_graph_route_equals_eager(card, label):
    g, q, m = card[label]
    shard = g._shards[0]
    args = (q, shard.base_dev, shard.graph, g._cfg, 10, 0.5, 64, m)
    eager = ann_query(*args, base_sq=shard.base_sq, route=graphs.EAGER)
    for _ in range(2):
        got, n = _launches_through_graphs(
            lambda: ann_query(*args, base_sq=shard.base_sq))
        _same([t.cpu() for t in got], [t.cpu() for t in eager])
        assert n == 0  # the row walk runs no kernel


@pytest.mark.cuda
def test_card_kquery_6000_graph_route_equals_eager(card):
    g, q, m = card["f32"]
    g.build_fused_index()
    shard = g._shards[0]
    q = q[:100]
    fused = [fused_query(q, shard.fused_index, shard.base_dev, 6000, 0.64, 400,
                         m, base_sq=shard.base_sq, route=r)
             for r in (graphs.EAGER, None)]
    _same([t.cpu() for t in fused[0]], [t.cpu() for t in fused[1]])
    row = [ann_query(q, shard.base_dev, shard.graph, g._cfg, 6000, 0.64, 400, m,
                     base_sq=shard.base_sq, route=r) for r in (graphs.EAGER, None)]
    _same([t.cpu() for t in row[0]], [t.cpu() for t in row[1]])
    d = fused[1][1].cpu().numpy()
    assert np.all(np.diff(d, axis=1)[np.isfinite(d[:, 1:])] >= 0)


@pytest.mark.cuda
def test_card_sym_walk_graph_route_equals_eager(card):
    """A layer-0 sym pass in walk mode: the walk's steps replayed as graphs
    give the per-step loop's graph and counters, with two captures for the
    pass's one walk shape (its uncapped first step and the capped steps,
    each a program of its own) and fewer live-count reads."""
    g, _, m = card["f32"]
    shard = g._shards[0]
    nbrs = shard.graph.neighbors[0]
    args = (shard.base_dev, shard.base_sq, nbrs, None, shard.graph.nn1_stats,
            g._cfg, 0, m, 0.5)
    want, want_stats = sym_pass(*args, mode="walk")  # the per-step loop
    got, stats = sym_pass(*args, mode="walk", route=graphs.GRAPHS)
    assert torch.equal(got, want)
    assert stats["walk_rows"] > 0
    for key in ("overflow", "added_links", "walk_rows", "total_rows"):
        assert stats[key] == want_stats[key], key
    assert stats["walk_graphs_captured"] == 2
    assert want_stats["walk_graphs_captured"] == 0
    assert stats["walk_live_reads"] < want_stats["walk_live_reads"]
    ptr = (str(nbrs.device), nbrs.data_ptr())
    assert not any(ptr in r for r in graphs.entries())


@pytest.mark.cuda
def test_card_rotated_equals_resident_through_graphs(cuda_device):
    graphs.clear()
    base, query = _sift_like(NC, 500, seed=1)
    g = GGNN(device=cuda_device)
    g.set_base(base)
    g.set_shard_size(NC // 4)
    g.set_max_device_shards(1)
    g.build(k_build=KC, tau_build=0.5, refinement_iterations=1)
    g.build_fused_index()
    kw = dict(engine="fused", num_seeds=8, rerank=16, width=32, cap=32,
              pops_per_iter=4)
    captures = [graphs.stats()["captures"]]
    rotated = g.query(query, 10, 0.64, 24, **kw)
    captures.append(graphs.stats()["captures"])
    again = g.query(query, 10, 0.64, 24, **kw)
    captures.append(graphs.stats()["captures"])
    assert all(r <= _tensor_ptrs(g) for r in graphs.entries())
    # the buffers' programs serve the shards that rotate through them
    assert captures[2] - captures[1] < captures[1] - captures[0]
    g.set_max_device_shards(4)
    resident = g.query(query, 10, 0.64, 24, **kw)
    np.testing.assert_array_equal(rotated.ids, resident.ids)
    np.testing.assert_array_equal(again.ids, resident.ids)
    rows = [g.query(query, 10, 0.5, 64, engine="row").ids for _ in range(2)]
    np.testing.assert_array_equal(rows[0], rows[1])
    g.close()
    assert graphs.entries() == []


def _round(device):
    g = GGNN(device=device)
    base, query = _sift_like(NC, 300, seed=2)
    g.set_base(base)
    g.set_shard_size(NC // 2)
    g.set_max_device_shards(1)
    g.build(k_build=KC, tau_build=0.5, refinement_iterations=1)
    g.build_fused_index()
    g.query(query, 10, 0.64, 24, engine="fused", num_seeds=8, rerank=16,
            width=32, cap=32, pops_per_iter=4)
    g.query(query, 10, 0.5, 64, engine="row")
    assert graphs.stats()["programs"] > 0
    return g


@pytest.mark.cuda
def test_card_memory_returns_after_del(cuda_device):
    """A GGNN dropped without ``close`` frees its device memory: the
    programs that read its tensors go with them, and their pools."""
    graphs.clear()
    del_g = _round(cuda_device)  # libraries, streams and workspaces first
    del del_g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    g = _round(cuda_device)
    assert torch.cuda.memory_allocated() > before
    del g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert graphs.stats()["programs"] == 0
    assert graphs.pool_bytes() in (0, None)
    assert torch.cuda.memory_allocated() == before


class _Wide(NamedTuple):
    x: torch.Tensor


@pytest.mark.cuda
def test_card_released_pool_returns_to_the_device(cuda_device):
    """Once the tensor a walk reads is freed, its program's pool goes back
    to the device: ``torch.cuda.memory_reserved()`` comes back near its
    value before the walk, and this test never calls ``empty_cache``. The
    walk's step makes an [n, n] f32 intermediate of twice what
    ``graphs.CACHE_SHARE`` lets dead pools keep (2.5 GB on an 80 GB card),
    which its graphs keep in their pool while the program lives."""
    graphs.clear()
    total = torch.cuda.get_device_properties(cuda_device).total_memory
    n = -(-int((2 * graphs.CACHE_SHARE * total / 4) ** 0.5) // 1024) * 1024

    def walk(table):
        def step(c, consts):
            wide = torch.outer(c.x + 1.0, table)  # [n, n] f32 in the pool
            x = c.x + wide[:, :1].squeeze(1) * 0.0 + 1.0
            return _Wide(x), x < 100.0

        live = torch.ones((n,), dtype=torch.bool, device=cuda_device)
        carry, *_ = graphs.run_steps(
            step, _Wide(torch.zeros((n,), device=cuda_device)), (), live, it=0,
            steps=8, live_n=n, floor=0, route=graphs.GRAPHS,
            name=("released pool",), reads=(table,))
        return carry.x

    # libraries, streams and the first pool come and go once
    walk(torch.ones((n,), device=cuda_device))
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    table = torch.ones((n,), device=cuda_device)
    x = walk(table)
    torch.cuda.synchronize()
    assert torch.equal(x, torch.full_like(x, 8.0))
    during = torch.cuda.memory_reserved()
    pool = graphs.pool_bytes()
    assert pool is None or pool >= n * n * 4
    assert during - before >= n * n * 4
    del table  # the program that reads it goes, and its pool with it
    after = torch.cuda.memory_reserved()
    assert graphs.stats()["programs"] == 0
    assert after - before <= 32 << 20, (before, during, after)
