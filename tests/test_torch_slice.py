"""The port's main path against the JAX package's, end to end.

* Query parity: the port's ``fused_query`` walks a graph and index that the
  JAX package built (carried across by ``ggnn_torch.convert``); its c@1 and
  c@10 must be within 0.003 of the JAX ``fused_query`` (``use_pallas=False``,
  ``seed_approx=False``) and its ids equal on at least 99% of rows.
* End-to-end parity: the port's ``GGNN`` build -> fused index -> brute
  force -> query -> ``Evaluator`` on the same data as the JAX ``GGNN``; c@1
  within 0.01. The builds are not bit-identical (f32 summation order, tie
  order, exact instead of approximate seed top-k), and 1000 queries resolve
  0.001.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ggnn_tpu
from ggnn_tpu.config import DistanceMeasure as JMeasure
from ggnn_tpu.ops import beam as jbeam
from ggnn_tpu.query.fused import fused_best_first as j_fused_best_first
from ggnn_tpu.query.fused import fused_query as j_fused_query
from ggnn_torch import GGNN, DistanceMeasure, Evaluator
from ggnn_torch.convert import fused_index_from_numpy, graph_from_numpy
from ggnn_torch.graph import load_graph_shard
from ggnn_torch.ops import beam as tbeam
from ggnn_torch.ops.distance import dist_block
from ggnn_torch.ops.topk import smallest_k_positions
from ggnn_torch.query.fused import (
    build_fused_index,
    fused_best_first,
    fused_best_first_compacted,
    fused_query,
)

N, NQ, D, K = 4096, 1000, 64, 16
QKW = dict(num_seeds=8, rerank=16, width=32, cap=32)
# (tau_query, pop budget, pops per step): a hard and an easy operating point
POINTS = [(0.5, 12, 4), (0.64, 32, 4)]
# The two builds draw their layer selections from different random streams
# (torch.Generator vs jax.random), so their graphs differ like two seeds of
# one package do; at the hard point above that alone moves c@1 by ~0.02
# (measured on this data: JAX seeds 1234/1235 give 0.933/0.940). End-to-end
# parity is held where the walk, not the seed, decides recall.
E2E_POINTS = [(0.5, 20, 4), (0.64, 24, 4)]


def _make_dataset(n, nq, d, d_latent=12, seed=0):
    """SIFT-like synthetic vectors (the benchmark's generator, scaled down)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d_latent, d)).astype(np.float32) / np.sqrt(d_latent)

    def sample(m):
        z = rng.normal(size=(m, d_latent)).astype(np.float32)
        x = z @ w * 40.0 + 128.0 + rng.normal(0, 4, size=(m, d)).astype(np.float32)
        return np.clip(x, 0, 255).astype(np.float32)

    return sample(n), sample(nq)


@pytest.fixture(scope="module")
def data():
    base, query = _make_dataset(N, NQ, D)
    jg = ggnn_tpu.GGNN()
    jg.set_base(base)
    jg.build(k_build=K, tau_build=0.5, refinement_iterations=2)
    jg.build_fused_index()
    gt, _ = jg.bf_query(query, k_gt=100)
    return base, query, np.asarray(gt), jg


def _c1_c10(evaluator, ids):
    ev = evaluator.evaluate_results(np.asarray(ids))
    return ev.c1, ev.cKQuery


@pytest.mark.parametrize("tau, iters, P", POINTS)
def test_query_parity_on_reference_graph(data, tau, iters, P, record_property):
    base, query, gt, jg = data
    shard = jg._shards[0]
    j_ids, _ = j_fused_query(
        jnp.asarray(query), shard.fused_index, shard.base_dev, 10, tau, iters,
        pops_per_iter=P, use_pallas=False, seed_approx=False, **QKW,
    )
    j_ids = np.asarray(j_ids)
    index = fused_index_from_numpy(shard.fused_index)
    ids, dists = fused_query(torch.from_numpy(query), index,
                             torch.from_numpy(base), 10, tau, iters,
                             pops_per_iter=P, **QKW)
    ids = ids.numpy()
    evaluator = Evaluator(base, query, gt, k_query=10)
    c1, c10 = _c1_c10(evaluator, ids)
    jc1, jc10 = _c1_c10(evaluator, j_ids)
    same = float(np.mean(np.all(ids == j_ids, axis=1)))
    record_property("c1", (c1, jc1))
    record_property("same_rows", same)
    print(f"tau={tau} iters={iters}: port c@1 {c1} c@10 {c10} | reference "
          f"c@1 {jc1} c@10 {jc10} | identical rows {same}")
    assert abs(c1 - jc1) <= 0.003 and abs(c10 - jc10) <= 0.003
    assert same >= 0.99
    assert np.all(np.diff(dists.numpy(), axis=1) >= 0)


def test_best_first_sweeps_agree(data):
    """One seeded beam walked to convergence three ways: the compacted sweep
    gives the plain sweep's beam exactly, and the JAX package's plain sweep
    the same ids on >= 99% of rows (f32 summation order)."""
    _, query, _, jg = data
    shard = jg._shards[0]
    index = fused_index_from_numpy(shard.fused_index)
    q = torch.from_numpy(query)
    q_sq = torch.sum(q * q, dim=-1)
    B, k_best, iters, P, cap = q.shape[0], 11, 400, 4, 32
    seed_d, pos = smallest_k_positions(
        dist_block(q, index.rep_vecs, q_sq=q_sq, c_sq=index.rep_sq), 8)
    seed_i = index.rep_ids[pos]
    xi = float(index.nn1_stats[0]) ** 2 * 0.25  # tau_build 0.5, as the merge
    ts = tbeam.beam_insert(tbeam.beam_init(B, 32, xi, 128), seed_i, seed_d,
                           criteria=torch.full((B,), float("inf")))
    js = jbeam.beam_insert(
        jbeam.beam_init(B, 32, jnp.float32(xi), 128), jnp.asarray(seed_i.numpy()),
        jnp.asarray(seed_d.numpy()), criteria=jnp.full((B,), jnp.inf, jnp.float32),
    )
    E = DistanceMeasure.Euclidean
    plain = fused_best_first(ts, q, q_sq, index, E, iters, k_best,
                             pops_per_iter=P, cap=cap)
    comp_i, comp_d = fused_best_first_compacted(ts, q, q_sq, index, E, iters,
                                                k_best, pops_per_iter=P, cap=cap)
    np.testing.assert_array_equal(comp_i.numpy(), plain.i[:, :k_best].numpy())
    np.testing.assert_array_equal(comp_d.numpy(), plain.d[:, :k_best].numpy())
    want = j_fused_best_first(js, jnp.asarray(query), jnp.asarray(q_sq.numpy()),
                              shard.fused_index, JMeasure.Euclidean, iters, k_best,
                              pops_per_iter=P, cap=cap, use_pallas=False)
    same = np.mean(np.all(np.asarray(want.i)[:, :k_best]
                          == plain.i[:, :k_best].numpy(), axis=1))
    print(f"best-first sweep: identical rows vs the JAX package {same}")
    assert same >= 0.99


def test_port_index_matches_reference_index(data):
    """The port's index assembled on the JAX-built graph equals the JAX
    index carried across."""
    base, _, _, jg = data
    shard = jg._shards[0]
    cfg = jg._cfg
    graph = graph_from_numpy(shard.graph)
    mine = build_fused_index(torch.from_numpy(base), graph, cfg)
    theirs = fused_index_from_numpy(shard.fused_index)
    for name in ("nbr_ids", "blocks", "scale", "zero", "rep_ids", "nn1_stats"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      getattr(theirs, name).numpy(), err_msg=name)
    for name in ("nbr_sq", "rep_vecs", "rep_sq"):
        np.testing.assert_allclose(getattr(mine, name).numpy(),
                                   getattr(theirs, name).numpy(), rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("group", [2, 4])
def test_match_groups_equal(data, group):
    """The copied numpy matching gives the reference's groups exactly."""
    from ggnn_tpu.query.fused import match_groups as j_match_groups
    from ggnn_torch.query.fused import match_groups

    nbr0 = np.asarray(data[3]._shards[0].graph.neighbors[0])
    np.testing.assert_array_equal(match_groups(nbr0, group),
                                  j_match_groups(nbr0, group))


@pytest.fixture(scope="module")
def port(data):
    base = data[0]
    g = GGNN(device="cpu")
    g.set_base(base)
    g.build(k_build=K, tau_build=0.5, refinement_iterations=2)
    g.build_fused_index()
    return g


@pytest.mark.parametrize("tau, iters, P", E2E_POINTS)
def test_end_to_end_parity(data, port, tau, iters, P, record_property):
    base, query, gt_ref, jg = data
    gt, _ = port.bf_query(query, k_gt=100)
    # brute force is exact: the port's ground truth is the reference's
    assert np.mean(gt == gt_ref) >= 0.999
    ids, _ = port.query(query, 10, tau, iters, engine="fused", pops_per_iter=P,
                        **QKW)
    j_ids, _ = jg.query(query, 10, tau, iters, engine="fused", pops_per_iter=P,
                        seed_approx=False, **QKW)
    c1, c10 = _c1_c10(Evaluator(base, query, gt, k_query=10), ids)
    jc1, jc10 = _c1_c10(Evaluator(base, query, gt_ref, k_query=10), j_ids)
    record_property("c1", (c1, jc1))
    print(f"tau={tau} iters={iters}: port build c@1 {c1} c@10 {c10} | "
          f"reference build c@1 {jc1} c@10 {jc10}")
    assert abs(c1 - jc1) <= 0.01 and abs(c10 - jc10) <= 0.01


def test_store_load_roundtrip(data, port, tmp_path):
    base, query, _, _ = data
    port.set_working_directory(tmp_path)
    port.store()
    g2 = GGNN(device="cpu")
    g2.set_base(base)
    g2.set_working_directory(tmp_path)
    g2.load(K)
    g2.build_fused_index()
    a, _ = port.query(query[:100], 10, 0.5, 16, engine="fused")
    b, _ = g2.query(query[:100], 10, 0.5, 16, engine="fused")
    np.testing.assert_array_equal(a, b)
    # the stored shard is the reference's format
    jgraph, jcfg = ggnn_tpu.graph.load_graph_shard(tmp_path / "part_0.npz")
    np.testing.assert_array_equal(np.asarray(jgraph.neighbors[0]),
                                  port.get_graph().neighbors[0].numpy())
    graph, cfg = load_graph_shard(tmp_path / "part_0.npz")
    assert cfg == port._cfg


def test_results_on_device_and_async(data, port):
    _, query, _, _ = data
    port.set_return_results_on_device(True)
    try:
        res = port.query_async(query[:50], 10, 0.5, 16, engine="fused").result()
        assert isinstance(res.ids, torch.Tensor) and res.ids.shape == (50, 10)
    finally:
        port.set_return_results_on_device(False)
    res = port.query(query[:50], 10, 0.5, 16, engine="fused")
    assert isinstance(res.ids, np.ndarray)
    np.testing.assert_array_equal(res.ids, np.asarray(res[0]))


def test_row_engine_default_and_async(data, port):
    """``query`` defaults to the row engine; ``query_async`` gives the same
    results for either engine."""
    base, query, gt, _ = data
    res = port.query(query, 10, 0.5, 64)
    c1 = Evaluator(base, query, gt, k_query=10).evaluate_results(res.ids).c1
    assert c1 >= 0.95
    exact = np.sum((base[res.ids] - query[:, None]) ** 2, axis=-1)
    np.testing.assert_allclose(res.dists, exact, rtol=1e-4, atol=1e-2)
    fut = port.query_async(query, 10, 0.5, 64)
    np.testing.assert_array_equal(fut.result().ids, res.ids)
    fused = port.query(query[:50], 10, 0.5, 16, engine="fused")
    fut = port.query_async(query[:50], 10, 0.5, 16, engine="fused")
    np.testing.assert_array_equal(fut.result().ids, fused.ids)


def test_outside_the_slice_raises(data, port):
    _, query, _, _ = data
    # several devices are the one part of the surface left to port
    with pytest.raises(NotImplementedError):
        port.set_devices(["cpu", "cpu"])
    with pytest.raises(NotImplementedError):
        port.set_gpus([0, 1])
    # a kwarg of the other engine is a tuning mistake, as in the reference
    with pytest.raises(ValueError):
        port.query(query[:10], 10, 0.5, 16, engine="fused",
                   fetch_cap_fraction=0.5)
    with pytest.raises(ValueError):
        port.query(query[:10], 10, 0.5, 16, engine="row", num_seeds=8)
    with pytest.raises(TypeError):
        port.query(query[:10], 10, 0.5, 16, engine="fused", sort_bf16=True)


def test_cuda_device_required():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        GGNN(device="cuda")
