"""The port's tensor primitives against the JAX package's, on the same numpy
inputs: distances (1e-5 relative: the f32 summation order differs),
brute-force kNN (ids equal up to exact distance ties), the beam operations
(exactly equal on states with distinct distances) and the evaluator."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.config import DistanceMeasure as JMeasure
from ggnn_tpu.evaluator import Evaluator as JEvaluator
from ggnn_tpu.ops import beam as jbeam
from ggnn_tpu.ops.bruteforce import bruteforce_knn as j_bruteforce
from ggnn_tpu.ops.distance import dist_block as j_dist_block
from ggnn_tpu.ops.distance import dist_gathered as j_dist_gathered
from ggnn_tpu.ops.distance import squared_norms as j_squared_norms
from ggnn_torch.config import DistanceMeasure
from ggnn_torch.evaluator import Evaluator
from ggnn_torch.ops import beam as tbeam
from ggnn_torch.ops.bruteforce import bruteforce_knn
from ggnn_torch.ops.distance import dist_block, dist_gathered, squared_norms
from ggnn_torch.ops.topk import smallest_k_positions
from torch_reference import one_torch_thread  # noqa: F401

MEASURES = [DistanceMeasure.Euclidean, DistanceMeasure.Cosine]


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("measure", MEASURES)
def test_dist_block_and_norms(measure):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 96)).astype(np.float32)
    c = rng.normal(size=(300, 96)).astype(np.float32)
    c[5] = 0.0  # a zero vector: cosine distance 1 by definition
    np.testing.assert_allclose(
        squared_norms(_t(c)).numpy(), np.asarray(j_squared_norms(jnp.asarray(c))),
        rtol=1e-5,
    )
    ref = np.asarray(j_dist_block(jnp.asarray(q), jnp.asarray(c), JMeasure(measure)))
    out = dist_block(_t(q), _t(c), measure).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("measure", MEASURES)
def test_dist_gathered(measure):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(32, 64)).astype(np.float32)
    cand = rng.normal(size=(32, 10, 64)).astype(np.float32)
    ref = np.asarray(j_dist_gathered(jnp.asarray(q), jnp.asarray(cand),
                                     JMeasure(measure)))
    out = dist_gathered(_t(q), _t(cand), measure).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def _exact_dists(base, query, ids, measure):
    b = base.astype(np.float64)[ids]
    q = query.astype(np.float64)[:, None, :]
    if measure == DistanceMeasure.Euclidean:
        return np.sum((b - q) ** 2, axis=-1)
    dot = np.sum(b * q, axis=-1)
    return np.abs(1.0 - dot / np.sqrt(np.sum(b * b, -1) * np.sum(q * q, -1)))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("measure", MEASURES)
def test_bruteforce_ids_equal_up_to_ties(measure, dtype):
    rng = np.random.default_rng(2)
    # small-range uint8 data has many exact distance ties
    base = rng.integers(0, 8, size=(3000, 16)).astype(dtype)
    query = rng.integers(0, 8, size=(100, 16)).astype(dtype)
    if dtype == np.float32:
        base = base + rng.normal(size=base.shape).astype(np.float32)
        query = query + rng.normal(size=query.shape).astype(np.float32)
    k = 20
    ref_i, ref_d = j_bruteforce(jnp.asarray(base), jnp.asarray(query), k,
                                JMeasure(measure), tile_base=1024)
    ref_i, ref_d = np.asarray(ref_i), np.asarray(ref_d)
    out_i, out_d = bruteforce_knn(_t(base), _t(query), k, measure, tile_base=1024)
    out_i, out_d = out_i.numpy(), out_d.numpy()
    np.testing.assert_allclose(out_d, ref_d, rtol=1e-5, atol=1e-5)
    # where the ids differ, both ids lie at the same exact distance
    diff = out_i != ref_i
    d_out = _exact_dists(base, query, out_i, measure)
    d_ref = _exact_dists(base, query, ref_i, measure)
    np.testing.assert_allclose(d_out[diff], d_ref[diff], rtol=1e-5, atol=1e-6)
    assert diff.mean() < 0.5 if dtype == np.uint8 else diff.mean() == 0.0


def test_smallest_k_positions_matches_top_k_order():
    import jax

    rng = np.random.default_rng(3)
    d = rng.integers(0, 5, size=(40, 30)).astype(np.float32)  # many ties
    neg, ref_pos = jax.lax.top_k(-jnp.asarray(d), 7)
    out_d, out_pos = smallest_k_positions(_t(d), 7)
    np.testing.assert_array_equal(out_d.numpy(), -np.asarray(neg))
    # the set at the k-th place may differ on a straddling tie; the order of
    # equal distances among the chosen is ascending position either way
    np.testing.assert_array_equal(
        np.take_along_axis(d, out_pos.numpy(), 1), out_d.numpy()
    )
    for row_d, row_p in zip(out_d.numpy(), out_pos.numpy()):
        for v in np.unique(row_d):
            p = row_p[row_d == v]
            assert np.all(np.diff(p) > 0)


def _random_beam(rng, B=16, W=32, V=16, fill=24):
    """A beam state with distinct finite distances, sorted, an empty tail."""
    d = np.full((B, W), np.inf, np.float32)
    i = np.full((B, W), -1, np.int32)
    exp = np.zeros((B, W), bool)
    for b in range(B):
        n = rng.integers(fill // 2, fill + 1)
        d[b, :n] = np.sort(rng.choice(10_000, n, replace=False)).astype(np.float32)
        i[b, :n] = rng.choice(500, n, replace=False)
        exp[b, :n] = rng.random(n) < 0.3
    vis = np.where(rng.random((B, V)) < 0.5, rng.integers(0, 500, (B, V)), -1)
    vis = vis.astype(np.int32)
    vis_head = rng.integers(0, V, B).astype(np.int32)
    xi = rng.uniform(0, 2000, B).astype(np.float32)
    return d, i, exp, vis, vis_head, xi


def _states(fields):
    j = jbeam.BeamState(*(jnp.asarray(x) for x in fields))
    t = tbeam.BeamState(*(_t(x) for x in fields))
    return j, t


def _assert_states_equal(js, ts):
    for name in ("d", "i", "vis", "vis_head", "xi"):
        np.testing.assert_array_equal(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)), err_msg=name
        )
    # the flag of an empty slot carries no meaning (and follows the order of
    # equal +inf keys); compare it on filled slots
    live = np.asarray(js.i) != -1
    np.testing.assert_array_equal(ts.exp.numpy()[live], np.asarray(js.exp)[live])


@pytest.mark.parametrize("P, k_best", [(1, 8), (4, 8), (8, 20)])
def test_beam_pop(P, k_best):
    rng = np.random.default_rng(P * 100 + k_best)
    js, ts = _states(_random_beam(rng))
    row_mask = rng.random(16) < 0.8
    ja, jact, js2 = jbeam.beam_pop(js, P, k_best, jnp.asarray(row_mask))
    ta, tact, ts2 = tbeam.beam_pop(ts, P, k_best, _t(row_mask))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    _assert_states_equal(js2, ts2)


def test_beam_dedup_mask():
    rng = np.random.default_rng(5)
    fields = _random_beam(rng)
    js, ts = _states(fields)
    cand = rng.integers(-1, 500, size=(16, 40)).astype(np.int32)
    cand[:, 10:20] = cand[:, :10]  # in-tile duplicates
    cand[:, 20:25] = fields[1][:, :5]  # ids already in the beam
    valid = rng.random((16, 40)) < 0.9
    ref = np.asarray(jbeam.beam_dedup_mask(js, jnp.asarray(cand), jnp.asarray(valid)))
    out = tbeam.beam_dedup_mask(ts, _t(cand), _t(valid)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_beam_insert():
    rng = np.random.default_rng(6)
    fields = _random_beam(rng)
    js, ts = _states(fields)
    B = 16
    # candidates unique and new to the beam, distances distinct from it
    cand = rng.choice(np.arange(500, 2000), size=(B, 12), replace=False).astype(np.int32)
    cand[rng.random((B, 12)) < 0.2] = -1
    cand_d = (rng.choice(10_000, size=(B, 12), replace=False) + 0.5).astype(np.float32)
    row_mask = rng.random(B) < 0.8
    crit = rng.uniform(2000, 12_000, B).astype(np.float32)
    js2 = jbeam.beam_insert(js, jnp.asarray(cand), jnp.asarray(cand_d),
                            jnp.asarray(row_mask), criteria=jnp.asarray(crit))
    ts2 = tbeam.beam_insert(ts, _t(cand), _t(cand_d), _t(row_mask),
                            criteria=_t(crit))
    _assert_states_equal(js2, ts2)


def test_beam_init():
    js = jbeam.beam_init(8, 64, jnp.float32(3.5), 40)
    ts = tbeam.beam_init(8, 64, torch.tensor(3.5), 40)
    _assert_states_equal(js, ts)
    np.testing.assert_array_equal(ts.exp.numpy(), np.asarray(js.exp))


@pytest.mark.parametrize("with_vectors", [True, False])
def test_evaluation_fields_equal(with_vectors):
    rng = np.random.default_rng(8)
    base = rng.normal(size=(500, 16)).astype(np.float32)
    base[100:110] = base[90:100]  # exact duplicates: tie handling
    query = rng.normal(size=(60, 16)).astype(np.float32)
    gt = np.argsort(((query[:, None] - base[None]) ** 2).sum(-1), axis=1)[:, :50]
    results = np.where(rng.random((60, 10)) < 0.8, gt[:, :10],
                       rng.integers(0, 500, (60, 10)))
    kw = {"base": base, "query": query} if with_vectors else {}
    ref = JEvaluator(gt=gt, k_query=10, **kw).evaluate_results(results)
    out = Evaluator(gt=gt, k_query=10, **kw).evaluate_results(results)
    np.testing.assert_array_equal(
        np.array(dataclasses.astuple(out), dtype=np.float64),
        np.array(dataclasses.astuple(ref), dtype=np.float64),
    )
