"""Several shards on one device and the out-of-core tiers, port against the
JAX package.

* The JAX ``GGNN`` builds 4 x 512 points and stores the parts with their
  fused sidecars; the port ``load``s them (reusing the sidecars) and answers
  row and fused queries whose merged ids equal the JAX package's on >= 99%
  of rows (fused with ``seed_approx=False``; only f32 summation order
  differs).
* ``bf_query`` over shards equals the JAX one up to exact distance ties.
* The merge keeps the reference's tie order (``lax.top_k``: the lower
  column first among equal distances).
* ``query_async`` equals ``query``; out of core (one shard on the device,
  every evicted host cache spilled to disk) the ids are identical to the
  resident run's, for both engines.
* The rotation stays exact, and loses no counter update, with the
  interpreter switching threads every microsecond.
* Several devices raise ``NotImplementedError``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ggnn_tpu
from ggnn_torch import GGNN

N_SHARD, D, KB = 512, 16, 12
NQ = 200
TAU, ITERS = 0.7, 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and beside other test
    processes their spinning costs many times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    rng = np.random.default_rng(7)
    base = rng.normal(size=(4 * N_SHARD, D)).astype(np.float32)
    query = rng.normal(size=(NQ, D)).astype(np.float32)
    d = tmp_path_factory.mktemp("parts")
    jg = ggnn_tpu.GGNN()
    jg.set_base(base)
    jg.set_shard_size(N_SHARD)
    jg.set_working_directory(d)
    jg.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
    jg.build_fused_index(group=2)
    jg.store()
    row = np.asarray(jg.query(query, 10, TAU, ITERS)[0])
    fused = np.asarray(jg.query(query, 10, TAU, ITERS, engine="fused",
                                seed_approx=False)[0])
    bf_ids, bf_d = jg.bf_query(query, k_gt=10)
    return {"base": base, "query": query, "dir": d, "row": row, "fused": fused,
            "bf": (np.asarray(bf_ids), np.asarray(bf_d))}


@pytest.fixture(scope="module")
def loaded(parts):
    g = GGNN(device="cpu")
    g.set_base(parts["base"])
    g.set_shard_size(N_SHARD)
    g.set_working_directory(parts["dir"])
    g.load(KB)
    yield g
    g.close()


def _same_rows(a, b):
    return float(np.mean(np.all(a == b, axis=1)))


def test_loaded_reference_parts_answer_like_reference(parts, loaded):
    g = loaded
    assert g.num_shards == 4 and g.has_fused_index()
    ids, dists = g.query(parts["query"], 10, TAU, ITERS)
    assert (ids // N_SHARD).max() > 0  # merged from several shards
    assert np.all(np.diff(dists, axis=1) >= 0)
    assert _same_rows(ids, parts["row"]) >= 0.99
    # the JAX sidecars are reused: no matching runs, every index re-assembles
    before = g.tier_stats["sidecar_reuses"]
    g.build_fused_index(group=2)
    assert g.tier_stats["sidecar_reuses"] - before == 4
    fids, fd = g.query(parts["query"], 10, TAU, ITERS, engine="fused")
    assert np.all(np.diff(fd, axis=1) >= 0)
    assert _same_rows(fids, parts["fused"]) >= 0.99


def test_bf_query_over_shards_equals_reference(parts, loaded):
    ids, dists = loaded.bf_query(parts["query"], k_gt=10)
    j_ids, j_d = parts["bf"]
    np.testing.assert_allclose(dists, j_d, rtol=1e-5, atol=1e-5)
    # ids differ only where two base points lie at the same distance
    base, query = parts["base"].astype(np.float64), parts["query"].astype(np.float64)
    rows, cols = np.nonzero(ids != j_ids)
    mine = np.sum((base[ids[rows, cols]] - query[rows]) ** 2, axis=-1)
    theirs = np.sum((base[j_ids[rows, cols]] - query[rows]) ** 2, axis=-1)
    np.testing.assert_allclose(mine, theirs, rtol=1e-6)


def test_merge_keeps_reference_tie_order():
    rng = np.random.default_rng(0)
    k, shards, rows, cols = 10, 3, 64, 8
    # few distinct distances: ties across and within shards everywhere
    d = [np.sort(rng.integers(0, 5, size=(rows, cols)).astype(np.float32), axis=1)
         for _ in range(shards)]
    ids = [np.arange(s * 100, s * 100 + cols, dtype=np.int32)[None].repeat(rows, 0)
           for s in range(shards)]
    partials = [(torch.from_numpy(i), torch.from_numpy(x)) for i, x in zip(ids, d)]
    m_ids, m_d = GGNN._merge_on_device(partials, k)
    # the JAX package's single-device merge (ggnn_tpu/ggnn.py _merge_on_device)
    neg, order = jax.lax.top_k(-jnp.concatenate([jnp.asarray(x) for x in d], 1), k)
    want = np.take_along_axis(np.concatenate(ids, 1), np.asarray(order), 1)
    np.testing.assert_array_equal(m_ids.numpy(), want)
    np.testing.assert_array_equal(m_d.numpy(), -np.asarray(neg))


def test_query_async_equals_query(parts, loaded):
    q = parts["query"][:50]
    for engine in ("row", "fused"):
        want = loaded.query(q, 10, TAU, ITERS, engine=engine)
        got = loaded.query_async(q, 10, TAU, ITERS, engine=engine).result()
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.dists, want.dists)


def test_out_of_core_identical_to_resident(parts, tmp_path):
    base, query = parts["base"], parts["query"]
    resident = GGNN(device="cpu")
    resident.set_base(base)
    resident.set_shard_size(N_SHARD)
    resident.build(k_build=KB, tau_build=0.5, refinement_iterations=0)

    g = GGNN(device="cpu")
    g.set_base(base)
    g.set_shard_size(N_SHARD)
    g.set_working_directory(tmp_path)
    g.set_max_device_shards(1)
    g.set_cpu_memory_limit(1)  # every eviction spills
    try:
        g.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
        for s in g._shards:
            s.wait()
        assert len(list(tmp_path.glob("part_*.npz"))) >= 3
        # every evicted shard's host cache was released after spilling
        assert all(s.resident or s.host_cache_bytes() == 0 for s in g._shards)
        assert sum(s.resident for s in g._shards) <= 1
        for engine in ("row", "fused"):
            if engine == "fused":
                resident.build_fused_index(group=2, bits=4)
                g.build_fused_index(group=2, bits=4)
            want = resident.query(query, 10, TAU, ITERS, engine=engine)
            # two calls: forward and back-to-front rotation
            for _ in range(2):
                ids, dists = g.query(query, 10, TAU, ITERS, engine=engine)
                np.testing.assert_array_equal(ids, want.ids)
                np.testing.assert_array_equal(dists, want.dists)
        stats = g.tier_stats
        assert stats["spills"] > 0 and stats["unspills"] > 0
        assert stats["stage_ins"] > 0 and stats["evictions"] > 0
        np.testing.assert_array_equal(g.bf_query(query, 10).ids,
                                      resident.bf_query(query, 10).ids)
    finally:
        g.close()


def test_rotation_with_threads_switching_often():
    """Eight shards through one device slot, every eviction spilling, the
    interpreter switching threads every microsecond: the disk-I/O pool and
    the caller share each shard and the tier counters, and no update may be
    lost (one spill per eviction, one read-back per stage-in)."""
    rng = np.random.default_rng(3)
    n_shard, shards = 256, 8
    base = rng.normal(size=(shards * n_shard, D)).astype(np.float32)
    query = rng.normal(size=(50, D)).astype(np.float32)
    resident = GGNN(device="cpu")
    resident.set_base(base)
    resident.set_shard_size(n_shard)
    resident.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
    want = resident.query(query, 10, TAU, ITERS)
    g = GGNN(device="cpu")
    g.set_base(base)
    g.set_shard_size(n_shard)
    g.set_max_device_shards(1)
    g.set_cpu_memory_limit(1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        g.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
        for _ in range(3):
            ids, dists = g.query(query, 10, TAU, ITERS)
            np.testing.assert_array_equal(ids, want.ids)
            np.testing.assert_array_equal(dists, want.dists)
        for s in g._shards:
            s.wait()
        stats = g.tier_stats
        assert stats["evictions"] >= shards
        assert stats["spills"] == stats["evictions"]
        assert stats["unspills"] == stats["stage_ins"] > 0
    finally:
        sys.setswitchinterval(interval)
        g.close()


def test_several_devices_raise():
    g = GGNN(device="cpu")
    with pytest.raises(NotImplementedError):
        g.set_devices(["cpu", "cpu"])
    with pytest.raises(NotImplementedError):
        g.set_gpus([0, 1])
    g.set_devices(["cpu"])  # one device is the port's slice
    assert g.device == torch.device("cpu")
