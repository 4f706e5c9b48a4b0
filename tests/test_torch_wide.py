"""The port at GIST1M's width (D = 960) and at GloVe's (D = 100, cosine)
end to end, and the counts that the benchmark's wide- and tail-kernel
metrics read.

CPU cases (no JAX; 2,048 points of the gist1m configuration's data model,
``annbench/data.py``):

* ``GGNN.build`` -> ``build_fused_index`` -> ``GGNN.query(engine="fused")``
  at the gist1m configuration's engine and operating point, held against
  the benchmark's plain reference (``annbench/reference.py``):
  every id in the base and none twice in a row, every returned distance
  within the configuration's ``dist_gap`` of the float64 distance of its
  id, and the exact 10 nearest found up to a recall floor.
* While a profiler records, the fused walk counts the anchors it hands
  the adjacency kernel (``adjacency.fetched_anchors``) as the visited
  ring's new entries; the count equals the anchors >= 0 of every call of
  the kernel, and nothing is counted without a profiler or where a group's
  members share one fetch.

The CPU build is lighter than the configuration's (k_build 12, no
refinement: its plain fetches at 960 dims take seconds a merge step); the
card case builds as the configuration says.

GloVe's width (3,001 points of the glove100 configuration's data model:
signed, not of unit norm; code rows of 100 bytes, which the card's tail
adjacency kernels read):

* On a cosine graph and fused index that the JAX package built (the
  shared reference, ``torch_reference.reference``), the port's
  ``fused_query`` reaches the JAX ``fused_query``'s c@1 and c@10 within
  0.003 (``use_pallas=False``, ``seed_approx=False``), ids equal on >= 99%
  of rows.
* The port's own cosine ``GGNN.build`` walks its merges through the
  quantized codes (``last_build_stats``' ``merge_fetch``), and with
  ``quantized_fetch=False`` through f32 rows; its fused query at the
  configuration's operating point returns distances within rtol 1e-5 of
  ``annbench/reference.py:pair_dists`` under cosine (float64), and its
  c@1 is within 0.01 of the JAX build's on the same data (two builds'
  random streams differ, as in ``test_torch_slice.py``).
* While a profiler records the walk counts its anchors under the tail
  kernel's variant, ``("u8_tail", 32, False)``.

Card case (marker ``cuda``; skipped without a card)::

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_wide.py

* The same query on the card launches the wide adjacency kernel and the
  gather + distance's four-slab instance, counted by variant.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from annbench import data, reference
from ggnn_torch import GGNN, DistanceMeasure, Evaluator
from ggnn_torch.convert import fused_index_from_numpy
from ggnn_torch.ops import adjacency, gather_dist
from ggnn_torch.query import fused
from torch_reference import one_torch_thread  # noqa: F401
from torch_reference import reference as jax_reference

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "annbench" / "configs" / "gist1m.json").read_text())
N, NQ, SEED = 2048, 200, 2**31 + 960
CPU_BUILD = dict(k_build=12, tau_build=CFG["tau_build"], refinement_iterations=0)
GLOVE = json.loads((ROOT / "annbench" / "configs" / "glove100.json").read_text())
NG, NQG, SEED_G = 3001, 500, 2**31 + 100
GLOVE_KW = dict(GLOVE["engine_kwargs"], pops_per_iter=GLOVE["pops_per_iter"])
# both packages' builds at the shared reference's k_build (16, not the
# configuration's 24: the CPU merges take a minute at 3,001 points)
GLOVE_K = 16
# the walk's parity points on the reference graph: a hard and an easy one
GLOVE_POINTS = [(0.5, 16, 4), (GLOVE["tau_query"], 64, GLOVE["pops_per_iter"])]


@pytest.fixture(scope="module")
def built():
    torch.manual_seed(0)
    base, pool = data.generate(CFG["data"], N, CFG["dim"], NQ, SEED, "cpu")
    g = GGNN(device="cpu")
    g.set_base(base.numpy())
    g.build(**CPU_BUILD)
    g.build_fused_index(group=CFG["group"], bits=CFG["bits"])
    yield g, base, pool
    g.close()


def _query(g, pool):
    kw = dict(CFG["engine_kwargs"], pops_per_iter=CFG["pops_per_iter"])
    ids, dists = g.query(pool.numpy(), CFG["k_query"], CFG["tau_query"],
                         CFG["max_iterations"], engine="fused", **kw)
    return np.asarray(ids), np.asarray(dists)


def test_fused_query_at_960_dims_against_the_reference(built):
    g, base, pool = built
    ids, dists = _query(g, pool)
    assert ids.shape == dists.shape == (NQ, CFG["k_query"])
    gt = reference.exact_knn(base, pool, 10)[0].numpy()
    recall = reference.recall_hits(ids, gt).sum() / gt.size
    checks = reference.judge(base, pool, np.arange(NQ), ids, dists,
                             CFG["limits"], recall=recall)
    assert checks["bad_ids"]["value"] == 0 and checks["dup_rows"]["value"] == 0
    assert checks["dist_gap"]["value"] <= checks["dist_gap"]["limit"]
    assert recall >= 0.9, recall


def test_traced_walk_counts_the_anchors_it_fetches(built, monkeypatch):
    g, _, pool = built
    handed = []
    kernel = fused.adjacency_dot

    def counting(qs, anchors, blocks, **kw):
        handed.append(int((anchors >= 0).sum()))
        return kernel(qs, anchors, blocks, **kw)

    monkeypatch.setattr(fused, "adjacency_dot", counting)
    key = adjacency.variant(CFG["dim"])
    assert key == ("u8", 32, True)
    before = adjacency.fetched_anchors().get(key, 0)
    a = _query(g, pool)
    assert adjacency.fetched_anchors().get(key, 0) == before and handed
    handed.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        b = _query(g, pool)
    assert adjacency.fetched_anchors()[key] - before == sum(handed) > 0
    assert all((x == y).all() for x, y in zip(a, b))


def test_groups_count_no_anchors(monkeypatch):
    """Where a group's members share one fetch the ring's entries are not
    the fetches: nothing is counted."""
    rng = np.random.default_rng(0)
    base = rng.random((1024, 32), dtype=np.float32)
    g = GGNN(device="cpu")
    g.set_base(base)
    g.build(k_build=12, tau_build=0.5, refinement_iterations=0)
    g.build_fused_index(group=2)
    before = adjacency.fetched_anchors()
    with profile(activities=[ProfilerActivity.CPU]):
        g.query(base[:64], 10, 0.5, 32, engine="fused")
    assert adjacency.fetched_anchors() == before
    g.close()


@pytest.mark.cuda
def test_cuda_query_at_960_dims_launches_the_wide_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    base, pool = data.generate(CFG["data"], 16_384, CFG["dim"], 1000, SEED, dev)
    g = GGNN(device=dev)
    g.set_base(base)
    g.build(k_build=CFG["k_build"], tau_build=CFG["tau_build"],
            refinement_iterations=CFG["refinement_iterations"])
    g.build_fused_index(group=CFG["group"], bits=CFG["bits"])
    wide = adjacency.variant(CFG["dim"])
    slabs = gather_dist.variant(1, CFG["dim"], False)
    a0 = adjacency.variant_launches().get(wide, 0)
    s0 = gather_dist.variant_launches().get(slabs, 0)
    kw = dict(CFG["engine_kwargs"], pops_per_iter=CFG["pops_per_iter"])
    ids, dists = g.query(pool, CFG["k_query"], CFG["tau_query"],
                         CFG["max_iterations"], engine="fused", **kw)
    torch.cuda.synchronize(dev)
    assert adjacency.variant_launches()[wide] > a0
    assert gather_dist.variant_launches()[slabs] == s0 + 1  # the re-rank
    gt = reference.exact_knn(base, pool, 10)[0].cpu().numpy()
    ids = np.asarray(torch.as_tensor(ids).cpu())
    assert reference.recall_hits(ids, gt).sum() / gt.size >= 0.9
    g.close()


@pytest.fixture(scope="module")
def glove_data():
    base, pool = data.generate(GLOVE["data"], NG, GLOVE["dim"], NQG, SEED_G, "cpu")
    gt = reference.exact_knn(base, pool, 10, measure="cosine")[0].numpy()
    return base.numpy(), pool.numpy(), gt


@pytest.fixture(scope="module")
def glove_jax(glove_data, tmp_path_factory, worker_id):
    jg = jax_reference(tmp_path_factory, worker_id, k_build=GLOVE_K,
                       measure="cosine", base=glove_data[0])
    jg.build_fused_index()
    return jg


@pytest.fixture(scope="module")
def glove_port(glove_data):
    g = GGNN(device="cpu")
    g.set_base(glove_data[0])
    g.build(k_build=GLOVE_K, tau_build=0.5, refinement_iterations=2,
            measure=DistanceMeasure.Cosine)
    g.build_fused_index(group=GLOVE["group"], bits=GLOVE["bits"])
    yield g
    g.close()


def _c1_c10(base, pool, gt, ids):
    ev = Evaluator(base, pool, gt, k_query=10).evaluate_results(np.asarray(ids))
    return ev.c1, ev.cKQuery


@pytest.mark.parametrize("tau, iters, P", GLOVE_POINTS)
def test_glove_query_parity_on_reference_graph(glove_data, glove_jax, tau, iters,
                                               P, record_property):
    import jax.numpy as jnp
    from ggnn_tpu.config import DistanceMeasure as JMeasure
    from ggnn_tpu.query.fused import fused_query as j_fused_query

    base, pool, gt = glove_data
    shard = glove_jax._shards[0]
    j_ids, _ = j_fused_query(jnp.asarray(pool), shard.fused_index, shard.base_dev,
                             10, tau, iters, JMeasure.Cosine, pops_per_iter=P,
                             use_pallas=False, seed_approx=False,
                             **GLOVE["engine_kwargs"])
    j_ids = np.asarray(j_ids)
    ids, dists = fused.fused_query(
        torch.from_numpy(pool), fused_index_from_numpy(shard.fused_index),
        torch.from_numpy(base), 10, tau, iters, DistanceMeasure.Cosine,
        pops_per_iter=P, **GLOVE["engine_kwargs"])
    ids = ids.numpy()
    c1, c10 = _c1_c10(base, pool, gt, ids)
    jc1, jc10 = _c1_c10(base, pool, gt, j_ids)
    same = float(np.mean(np.all(ids == j_ids, axis=1)))
    record_property("c1", (c1, jc1))
    print(f"glove tau={tau} iters={iters}: port c@1 {c1} c@10 {c10} | reference "
          f"c@1 {jc1} c@10 {jc10} | identical rows {same}")
    assert abs(c1 - jc1) <= 0.003 and abs(c10 - jc10) <= 0.003
    assert same >= 0.99
    assert np.all(np.diff(dists.numpy(), axis=1) >= 0)


def _glove_query(g, pool):
    ids, dists = g.query(pool, GLOVE["k_query"], GLOVE["tau_query"],
                         GLOVE["max_iterations"], engine="fused", **GLOVE_KW)
    return np.asarray(ids), np.asarray(dists)


def test_glove_cosine_build_walks_the_codes(glove_port):
    fetch = glove_port.last_build_stats["shards"][0]["merge_fetch"]
    assert fetch["quantized"] > 0 and fetch["f32"] == 0, fetch
    phases = glove_port.last_build_stats["shards"][0]["phases"]
    assert "quantize" in phases and any(k.startswith("adj[") for k in phases)


def test_build_stats_record_f32_merges(glove_data):
    g = GGNN(device="cpu")
    g.set_base(glove_data[0][:1024])
    g.build(k_build=12, tau_build=0.5, refinement_iterations=0,
            measure=DistanceMeasure.Cosine, quantized_fetch=False)
    fetch = g.last_build_stats["shards"][0]["merge_fetch"]
    assert fetch["quantized"] == 0 and fetch["f32"] > 0, fetch
    g.close()


def test_glove_fused_query_against_the_reference(glove_data, glove_port):
    base, pool, gt = glove_data
    ids, dists = _glove_query(glove_port, pool)
    assert ids.shape == dists.shape == (NQG, GLOVE["k_query"])
    want = reference.pair_dists(torch.from_numpy(base), torch.from_numpy(pool),
                                torch.from_numpy(ids), measure="cosine").numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(dists, want, rtol=1e-5, atol=1e-6)
    recall = reference.recall_hits(ids, gt).sum() / gt.size
    checks = reference.judge(torch.from_numpy(base), torch.from_numpy(pool),
                             np.arange(NQG), ids, dists, GLOVE["limits"],
                             recall=recall, measure="cosine")
    assert reference.passed(checks), checks


def test_glove_end_to_end_against_the_jax_build(glove_data, glove_jax, glove_port,
                                                record_property):
    from ggnn_tpu.config import DistanceMeasure as JMeasure

    base, pool, gt = glove_data
    ids, _ = glove_port.query(pool, 10, GLOVE["tau_query"], 64, engine="fused",
                              seed_approx=False, **GLOVE_KW)
    j_ids, _ = glove_jax.query(pool, 10, GLOVE["tau_query"], 64, JMeasure.Cosine,
                               engine="fused", seed_approx=False, **GLOVE_KW)
    c1, c10 = _c1_c10(base, pool, gt, ids)
    jc1, jc10 = _c1_c10(base, pool, gt, j_ids)
    record_property("c1", (c1, jc1))
    print(f"glove: port build c@1 {c1} c@10 {c10} | reference build c@1 {jc1} "
          f"c@10 {jc10}")
    assert abs(c1 - jc1) <= 0.01 and abs(c10 - jc10) <= 0.01


def test_glove_traced_walk_counts_under_the_tail_key(glove_data, glove_port):
    key = adjacency.variant(GLOVE["dim"])
    assert key == ("u8_tail", 32, False)
    before = adjacency.fetched_anchors().get(key, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        _glove_query(glove_port, glove_data[1][:64])
    assert adjacency.fetched_anchors()[key] > before
