"""The sym pass's inverse-link walk as a device program
(``ggnn_torch/build/sym.py`` on ``ggnn_torch/utils/graphs.py``).

The JAX package walks each group of row chunks in one device program
(``_sym_scan_block``: a scan over chunks, each a ``lax.while_loop`` of walk
steps, then the chunk's request insertion). The port's walk steps
through ``graphs.run_steps``: by default the per-step loop (one live-count
read per step), or, asked for, CUDA graphs of ``S`` steps on the card with
one read per replay. CPU cases (2,048 points, D=32,
k=16, one intra-op thread; the input is the JAX package's own top-merge
layer 0: a JAX build of the whole schedule would cost tens of seconds of
compiles on the CPU):

* (a) ``_sym_walk`` through the chunked check -- the graph route's programs
  run on the CPU without a graph, S steps between two reads of the live
  count -- against the per-step loop, bit for bit on ``connected`` and the
  preference lists, with S in {1, 3, 4}, P in {2, 4} and a layer reached
  through a translation; at most one live-count read per S steps, none
  after the replay that spends the step budget.
* (b) ``sym_pass`` in ``walk`` and ``hybrid`` mode, whose last chunk is
  padded with empty rows to equal slices, against the same pass walking
  each chunk's rows unpadded in uneven slices: identical ``new_nbrs`` and
  counters; and a pass with few pairs walks one slice of the JAX package's
  ladder (a power of two of at least 4096 pairs).
* (c) ``sym_pass`` in ``walk`` and ``hybrid`` mode against the JAX
  package's ``sym_pass`` on the same layer 0: local slots identical,
  foreign-link overlap >= 0.99, every
  counter within 1% (the bar of ``tests/test_torch_row.py``, which holds
  the walking modes on a fully built JAX layer 0).
* (d) After a ``sym_pass`` no walk program reads its input graph or its
  request buffer; by default a pass walks on the per-step loop, with no
  program at all.

The card case (both routes of a ``sym_pass`` bit for bit) lives in
``tests/test_torch_walk_graphs.py`` with the other card-only walk tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.build import sym as jsym
from ggnn_tpu.build.top_merge import top_merge_layer as j_top_merge
from ggnn_tpu.config import DistanceMeasure as JMeasure
from ggnn_tpu.config import GraphConfig as JGraphConfig
from ggnn_tpu.ops.distance import squared_norms as j_squared_norms
from ggnn_torch.build import sym as tsym
from ggnn_torch.config import DistanceMeasure, GraphConfig, SYM_MAX_PER_PATH_ITERATIONS
from ggnn_torch.ops.distance import squared_norms
from ggnn_torch.utils import graphs
from torch_reference import one_torch_thread  # noqa: F401

N, D, K = 2048, 32, 16
TAU = 0.5
E = DistanceMeasure.Euclidean
CHUNK_NODES = 128  # several walk chunks at this size
HUB = 256


def _t(x):
    return torch.from_numpy(np.array(x))


def _overlap(a, b):
    """Mean fraction of shared neighbour ids per row."""
    return float(np.mean([
        len(set(x[x >= 0]) & set(y[y >= 0])) / max(1, len(set(x[x >= 0])))
        for x, y in zip(a, b)
    ]))


@pytest.fixture(scope="module")
def layer0():
    """The JAX package's top-merge layer 0 of SIFT-like data (the
    benchmark's generator, scaled down), with its 1-NN statistics."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(12, D)).astype(np.float32) / np.sqrt(12)
    z = rng.normal(size=(N, 12)).astype(np.float32)
    base = np.clip(z @ w * 40.0 + 128.0 + rng.normal(0, 4, size=(N, D)),
                   0, 255).astype(np.float32)
    jcfg = JGraphConfig.create(N=N, D=D, KBuild=K)
    jb = jnp.asarray(base)
    jb_sq = j_squared_norms(jb)
    nbrs, nn1 = j_top_merge(jb, jb_sq, None, jcfg, 0, JMeasure.Euclidean)
    nn1_stats = jnp.stack([jnp.mean(nn1), jnp.max(nn1)])
    cfg = GraphConfig.create(N=N, D=D, KBuild=K)
    # the same layer with each node's last local link turned to the first
    # node of its block of HUB: the hubs' requests overflow, so hybrid mode
    # is left pairs to walk (the top merge alone leaves it none)
    hubs = np.array(nbrs)
    hub = np.arange(N) // HUB * HUB
    hubs[hub != np.arange(N), cfg.KL - 1] = hub[hub != np.arange(N)]
    bt = _t(base)
    return {"base": bt, "base_sq": squared_norms(bt), "nn1_stats": _t(nn1_stats),
            "cfg": cfg, "jcfg": jcfg, "jbase": jb, "jbase_sq": jb_sq,
            "jnn1_stats": nn1_stats, "nbrs": {"top": nbrs, "hubs": hubs}}


def _sym_pass(l0, mode, graph="top", **kw):
    return tsym.sym_pass(l0["base"], l0["base_sq"], _t(l0["nbrs"][graph]), None,
                         l0["nn1_stats"], l0["cfg"], 0, E, TAU, mode=mode, **kw)


# --- (a) the walk: S steps per read against the per-step loop ---------------


def _walk_inputs(l0, translated):
    """Every flagged (node, neighbour) pair of layer 0 and a partly filled
    request buffer; ``translated`` reads the base through a permutation, as
    a layer above 0 does."""
    cfg, nbrs = l0["cfg"], _t(l0["nbrs"]["top"])
    KL = cfg.KL
    rows = torch.nonzero(tsym._rows_needing_walk(nbrs, KL=KL).reshape(-1))[:, 0]
    n = rows // KL
    start = nbrs[n, rows % KL].long()
    rng = np.random.default_rng(5)
    buf = _t(np.where(rng.random((N, cfg.KF)) < 0.3,
                      rng.integers(0, N, (N, cfg.KF)), -1).astype(np.int32))
    trans = None
    if translated:
        trans = _t(rng.permutation(N).astype(np.int32))
    xi = l0["nn1_stats"][0] ** 2 * TAU * TAU
    return n, start, nbrs, buf, trans, xi


@pytest.mark.parametrize("S, P, translated", [
    (1, 4, False), (3, 4, False), (4, 4, False),
    (1, 2, False), (3, 2, False), (4, 2, True)])
def test_sym_walk_chunked_equals_per_step(layer0, S, P, translated, monkeypatch):
    n, start, nbrs, buf, trans, xi = _walk_inputs(layer0, translated)
    kw = dict(cfg=layer0["cfg"], measure=E, pops_per_iter=P)
    args = (n, start, nbrs, buf, trans, layer0["base"], layer0["base_sq"], xi)
    want_c, want_p = tsym._sym_walk(*args, route=graphs.EAGER, **kw)
    monkeypatch.setattr(graphs, "STEPS_PER_REPLAY", S)
    reads = graphs.thread_live_reads()
    got_c, got_p = tsym._sym_walk(*args, route=graphs.GRAPHS, **kw)
    reads = graphs.thread_live_reads() - reads
    assert torch.equal(got_c, want_c)
    assert torch.equal(got_p, want_p)
    # the first step runs eagerly, then one read per replay of S steps but
    # the one that spends the budget
    remaining = -(-SYM_MAX_PER_PATH_ITERATIONS // P) - 1
    assert reads <= -(-remaining // S) - 1
    assert 0 < int(got_c.sum()) < n.shape[0]


# --- (b) padded, equal slices against unpadded, uneven ones ------------------


def _walk_requests_unpadded(chunk_rows):
    """Phase iii as the port walked it before its chunks were padded: each
    chunk's real rows in slices of ``_WALK_BATCH``, the last one shorter,
    chunks of ``chunk_rows`` pairs whatever the mode."""

    def walk(rows, nbrs, trans, base, base_sq, xi, sym_buffer, sym_atomic, *,
             cfg, measure, pops_per_iter, route=None, **_):
        KL, batch = cfg.KL, tsym._WALK_BATCH
        for lo in range(0, rows.shape[0], chunk_rows):
            r = rows[lo : lo + chunk_rows]
            n = r // KL
            start = nbrs[n, r % KL].long()
            pad = start == -1
            start = torch.where(pad, n, start)
            parts = [
                tsym._sym_walk(n[b : b + batch], start[b : b + batch], nbrs,
                               sym_buffer, trans, base, base_sq, xi, cfg=cfg,
                               measure=measure, pops_per_iter=pops_per_iter,
                               route=graphs.EAGER)
                for b in range(0, r.shape[0], batch)
            ]
            connected = torch.cat([c for c, _ in parts])
            pref = torch.cat([p for _, p in parts])
            tsym._insert_requests(pref, n, ~connected & ~pad, sym_buffer,
                                  sym_atomic, KF=cfg.KF)

    return walk


@pytest.mark.parametrize("mode, graph", [("walk", "top"), ("hybrid", "hubs")])
def test_padded_walk_equals_unpadded(layer0, mode, graph, monkeypatch):
    monkeypatch.setattr(tsym, "_WALK_BATCH", 300)  # uneven slices unpadded
    got, got_stats = _sym_pass(layer0, mode, graph, chunk_nodes=CHUNK_NODES,
                               route=graphs.GRAPHS)
    monkeypatch.setattr(tsym, "_walk_requests", _walk_requests_unpadded(
        CHUNK_NODES * layer0["cfg"].KL))
    want, want_stats = _sym_pass(layer0, mode, graph, chunk_nodes=CHUNK_NODES)
    assert got_stats["walk_rows"] > 0
    assert torch.equal(got, want)
    for key in ("overflow", "added_links", "N", "walk_rows", "dropped_rows",
                "bulk_connected", "bulk_accepted", "total_rows"):
        assert got_stats[key] == want_stats[key], key


@pytest.mark.parametrize("mode, graph", [("walk", "top"), ("hybrid", "hubs")])
def test_ladder_sizes_the_walk(layer0, mode, graph, monkeypatch):
    """A pass with fewer pairs to walk than a chunk holds walks one slice
    of the ladder's size (the power of two of at least 4096 pairs that
    holds them), not of ``chunk_nodes * KL``."""
    shapes = []
    walk = tsym._sym_walk

    def record(n, *args, **kw):
        shapes.append(n.shape[0])
        return walk(n, *args, **kw)

    monkeypatch.setattr(tsym, "_sym_walk", record)
    _, stats = _sym_pass(layer0, mode, graph)
    assert 0 < stats["walk_rows"] <= 4096 < N * layer0["cfg"].KL
    assert shapes == [4096]


# --- (c) against the JAX package's sym pass ----------------------------------


@pytest.mark.parametrize("mode, graph", [
    ("walk", "top"), ("hybrid", "top"), ("hybrid", "hubs")])
def test_sym_pass_matches_reference(layer0, mode, graph, record_property):
    want, want_stats = jsym.sym_pass(
        layer0["jbase"], layer0["jbase_sq"], jnp.asarray(layer0["nbrs"][graph]),
        None, layer0["jnn1_stats"], layer0["jcfg"], 0, JMeasure.Euclidean, TAU,
        mode=mode)
    want = np.asarray(want)
    got, stats = _sym_pass(layer0, mode, graph)
    got = got.numpy()
    KL = layer0["cfg"].KL
    np.testing.assert_array_equal(got[:, :KL], want[:, :KL])
    overlap = _overlap(got[:, KL:], want[:, KL:])
    record_property("foreign_link_overlap", overlap)
    print(f"sym {mode} ({graph}): overlap {overlap:.5f}; stats "
          f"{stats} vs {want_stats}")
    assert overlap >= 0.99
    if mode == "walk" or graph == "hubs":
        assert stats["walk_rows"] > 0
    # within 1% of the reference's value (and within 1 for counts below 100)
    for key in ("overflow", "added_links", "walk_rows", "dropped_rows",
                "bulk_connected", "bulk_accepted"):
        bound = 0.01 * max(want_stats[key], 100)
        assert abs(stats[key] - want_stats[key]) <= bound, key


# --- (d) the programs go with the pass ---------------------------------------


def test_sym_pass_releases_its_programs(layer0):
    graphs.clear()
    nbrs = _t(layer0["nbrs"]["top"])
    reads = graphs.thread_live_reads()
    replays = graphs.stats()["replays"]
    _, stats = tsym.sym_pass(layer0["base"], layer0["base_sq"], nbrs, None,
                             layer0["nn1_stats"], layer0["cfg"], 0, E, TAU,
                             mode="walk", route=graphs.GRAPHS)
    assert stats["walk_live_reads"] == graphs.thread_live_reads() - reads
    assert graphs.stats()["replays"] > replays
    assert stats["walk_graphs_captured"] == 0  # no graph on the CPU
    ptr = (str(nbrs.device), nbrs.data_ptr())
    assert not any(ptr in r for r in graphs.entries())
    assert graphs.stats()["programs"] == 0


def test_sym_pass_walks_per_step_by_default(layer0):
    """Without ``route`` the walk takes the per-step loop, whatever the
    device: no program, one live-count read per step but the last."""
    replays = graphs.stats()["replays"]
    reads = graphs.thread_live_reads()
    _, stats = _sym_pass(layer0, "walk")
    assert graphs.stats()["replays"] == replays
    assert stats["walk_live_reads"] == graphs.thread_live_reads() - reads > 0
    assert stats["walk_graphs_captured"] == 0
