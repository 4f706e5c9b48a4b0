"""Several device slots in ``GGNN``, port against the JAX package.

* The JAX ``GGNN`` on two (virtual) devices builds 2 x 512 and 4 x 512
  points and stores the parts; the port ``load``s them on two CPU slots
  (``set_devices(["cpu", "cpu"])``). Its host merge answers row and fused
  queries whose ids equal the JAX host merge's (``set_ici_merge(False)``)
  on >= 99% of rows (fused with ``seed_approx=False``; only f32 summation
  order differs), and ``bf_query`` equals the JAX brute force up to exact
  distance ties.
* The device merge (one shard per slot) returns exactly the host merge's
  ids and distances; ``query_async`` equals ``query``; results left on the
  device come back on the first slot's device.
* 4 shards on 2 slots with at most 2 resident rotate to ids identical to
  the resident run's.
* A build on 2 slots (one worker each) gives graphs bit-identical to the
  same build on 1 slot, with the interpreter switching threads every
  microsecond and every eviction spilling from the workers.
* The divisibility errors of the JAX package, and the one deviation: two
  slots on one device stay two slots (two build workers, the device merge),
  where the JAX package collapses them into one.
"""

import sys

import jax
import numpy as np
import pytest
import torch

import ggnn_tpu
from ggnn_torch import GGNN
from torch_reference import one_torch_thread  # noqa: F401

N_SHARD, D, KB = 512, 16, 12
NQ = 200
TAU, ITERS = 0.7, 64
SLOTS = ["cpu", "cpu"]


def _jax_parts(base, query, d, n_shards):
    jg = ggnn_tpu.GGNN(devices=jax.devices()[:2])
    jg.set_base(base[: n_shards * N_SHARD])
    jg.set_shard_size(N_SHARD)
    jg.set_working_directory(d)
    jg.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
    jg.build_fused_index()
    jg.store()
    jg.set_ici_merge(False)  # the JAX host merge
    row = np.asarray(jg.query(query, 10, TAU, ITERS)[0])
    fused = np.asarray(jg.query(query, 10, TAU, ITERS, engine="fused",
                                seed_approx=False)[0])
    bf_ids, bf_d = jg.bf_query(query, k_gt=10)
    return {"dir": d, "n": n_shards * N_SHARD, "row": row, "fused": fused,
            "bf": (np.asarray(bf_ids), np.asarray(bf_d)),
            "workers": jg.last_build_stats["num_build_workers"]}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    base = rng.normal(size=(4 * N_SHARD, D)).astype(np.float32)
    query = rng.normal(size=(NQ, D)).astype(np.float32)
    return base, query


@pytest.fixture(scope="module")
def parts(data, tmp_path_factory):
    base, query = data
    return {n: _jax_parts(base, query, tmp_path_factory.mktemp(f"parts{n}"), n)
            for n in (2, 4)}


def _load(base, part, device_merge=True, max_device_shards=None):
    g = GGNN(device="cpu")
    g.set_devices(SLOTS)
    g.set_base(base[: part["n"]])
    g.set_shard_size(N_SHARD)
    g.set_working_directory(part["dir"])
    g.set_device_merge(device_merge)
    g.set_max_device_shards(max_device_shards)
    g.load(KB)
    g.build_fused_index()
    return g


def _same_rows(a, b):
    return float(np.mean(np.all(a == b, axis=1)))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_host_merge_matches_jax_host_merge(data, parts, n_shards):
    base, query = data
    part = parts[n_shards]
    assert part["workers"] == 2
    g = _load(base, part, device_merge=False)
    try:
        assert [s.slot for s in g._shards] == [i * 2 // n_shards
                                               for i in range(n_shards)]
        assert g.tier_stats["sidecar_reuses"] == n_shards
        ids, dists = g.query(query, 10, TAU, ITERS)
        assert g.last_merge_route == "host"
        assert (ids // N_SHARD).max() == n_shards - 1  # merged from all shards
        assert np.all(np.diff(dists, axis=1) >= 0)
        assert _same_rows(ids, part["row"]) >= 0.99
        fids, fd = g.query(query, 10, TAU, ITERS, engine="fused",
                           seed_approx=False)
        assert g.last_merge_route == "host"
        assert np.all(np.diff(fd, axis=1) >= 0)
        assert _same_rows(fids, part["fused"]) >= 0.99
    finally:
        g.close()


def test_device_merge_equals_host_merge(data, parts):
    base, query = data
    g = _load(base, parts[2])
    try:
        for engine, kw in (("row", {}), ("fused", {"rerank": 24, "cap": 48})):
            dev = g.query(query, 10, TAU, ITERS, engine=engine, **kw)
            assert g.last_merge_route == "devices"
            g.set_device_merge(False)
            host = g.query(query, 10, TAU, ITERS, engine=engine, **kw)
            assert g.last_merge_route == "host"
            g.set_device_merge(True)
            np.testing.assert_array_equal(dev.ids, host.ids)
            np.testing.assert_array_equal(dev.dists, host.dists)
    finally:
        g.close()


@pytest.mark.parametrize("n_shards, device_merge",
                         [(2, True), (2, False), (4, True)])
def test_bf_query_equals_jax(data, parts, n_shards, device_merge):
    base, query = data
    part = parts[n_shards]
    g = _load(base, part, device_merge)
    try:
        ids, dists = g.bf_query(query, k_gt=10)
        assert g.last_merge_route == ("devices" if device_merge and n_shards == 2
                                      else "host")
    finally:
        g.close()
    j_ids, j_d = part["bf"]
    np.testing.assert_allclose(dists, j_d, rtol=1e-5, atol=1e-5)
    # ids differ only where two base points lie at the same distance
    b, q = base.astype(np.float64), query.astype(np.float64)
    rows, cols = np.nonzero(ids != j_ids)
    mine = np.sum((b[ids[rows, cols]] - q[rows]) ** 2, axis=-1)
    theirs = np.sum((b[j_ids[rows, cols]] - q[rows]) ** 2, axis=-1)
    np.testing.assert_allclose(mine, theirs, rtol=1e-6)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_async_and_results_on_device(data, parts, n_shards):
    """``query_async`` equals ``query`` on either merge route; results left
    on the device come back as tensors on the first slot's device."""
    base, query = data
    g = _load(base, parts[n_shards])
    q = query[:50]
    try:
        for engine in ("row", "fused"):
            want = g.query(q, 10, TAU, ITERS, engine=engine)
            got = g.query_async(q, 10, TAU, ITERS, engine=engine).result()
            np.testing.assert_array_equal(got.ids, want.ids)
            np.testing.assert_array_equal(got.dists, want.dists)
            g.set_return_results_on_device(True)
            on_dev = g.query_async(q, 10, TAU, ITERS, engine=engine).result()
            g.set_return_results_on_device(False)
            assert isinstance(on_dev.ids, torch.Tensor)
            assert on_dev.ids.device == g.devices[0]
            np.testing.assert_array_equal(on_dev.ids.numpy(), want.ids)
        g.set_return_results_on_device(True)
        gt = g.bf_query(q, k_gt=10)
        assert isinstance(gt.dists, torch.Tensor) and gt.dists.device == g.devices[0]
    finally:
        g.close()


def test_two_slots_out_of_core_identical_to_resident(data, parts, tmp_path):
    base, query = data
    resident = _load(base, parts[4])
    g = _load(base, parts[4], max_device_shards=2)
    g.set_working_directory(tmp_path)
    g.set_cpu_memory_limit(1)  # every eviction spills
    try:
        for engine in ("row", "fused"):
            want = resident.query(query, 10, TAU, ITERS, engine=engine)
            for _ in range(2):  # forward and back-to-front rotation
                ids, dists = g.query(query, 10, TAU, ITERS, engine=engine)
                np.testing.assert_array_equal(ids, want.ids)
                np.testing.assert_array_equal(dists, want.dists)
            assert sum(s.resident for s in g._shards) <= 2
        stats = g.tier_stats
        assert stats["stage_ins"] > 0 and stats["spills"] > 0
    finally:
        g.close()
        resident.close()


def test_build_on_two_slots_equals_one_slot(data, tmp_path):
    """One build worker per slot, each evicting and spilling its shards, the
    interpreter switching threads every microsecond: the graphs are the
    one-slot build's, bit for bit (shard i is seeded 1234 + i whichever
    worker builds it), and no tier count is lost."""
    base, query = data
    one = GGNN(device="cpu")
    one.set_base(base)
    one.set_shard_size(N_SHARD)
    one.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
    assert one.last_build_stats["num_build_workers"] == 1
    two = GGNN(device="cpu")
    two.set_devices(SLOTS)
    two.set_base(base)
    two.set_shard_size(N_SHARD)
    two.set_max_device_shards(2)
    two.set_cpu_memory_limit(1)
    two.set_working_directory(tmp_path)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        two.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
        for s in two._shards:
            s.wait()
    finally:
        sys.setswitchinterval(interval)
    try:
        stats = two.last_build_stats
        assert stats["num_build_workers"] == 2 and len(stats["shards"]) == 4
        assert two.tier_stats["evictions"] == 4 == two.tier_stats["spills"]
        for i in range(4):
            a, b = one.get_graph(i), two.get_graph(i)
            for x, y in zip(a, b):
                for u, v in zip(x if isinstance(x, tuple) else (x,),
                                y if isinstance(y, tuple) else (y,)):
                    assert torch.equal(u, v)
        np.testing.assert_array_equal(two.query(query, 10, TAU, ITERS).ids,
                                      one.query(query, 10, TAU, ITERS).ids)
    finally:
        two.close()
        one.close()


def test_divisibility_errors(data):
    base, _ = data
    g = GGNN(device="cpu")
    g.set_devices(["cpu"] * 3)
    g.set_base(base[:1000])
    with pytest.raises(ValueError, match="divisible by the number of devices"):
        g.build(k_build=KB, tau_build=0.5)
    g.set_devices(SLOTS)
    g.set_base(base[: 3 * N_SHARD])
    g.set_shard_size(N_SHARD)
    with pytest.raises(ValueError, match="shards 3 not divisible"):
        g.build(k_build=KB, tau_build=0.5)
    with pytest.raises(ValueError, match="at least one device"):
        g.set_devices([])


def test_repeated_device_deviation(data, parts):
    """The JAX package keys shards by device, so a repeated device is one
    build worker and its single-device merge; the port keys them by slot:
    two workers and the device merge route. The answers agree."""
    base, query = data
    d0 = jax.devices()[0]
    jg = ggnn_tpu.GGNN(devices=[d0, d0])
    jg.set_base(base[: 2 * N_SHARD])
    jg.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
    assert jg.last_build_stats["num_build_workers"] == 1
    assert len({s.device for s in jg._shards}) == 1
    j_ids = np.asarray(jg.query(query, 10, TAU, ITERS)[0])
    g = GGNN(device="cpu")
    g.set_devices(SLOTS)
    g.set_base(base[: 2 * N_SHARD])
    g.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
    assert g.last_build_stats["num_build_workers"] == 2
    ids = g.query(query, 10, TAU, ITERS).ids
    assert g.last_merge_route == "devices"
    # the two builds differ like two seeds (torch vs jax.random streams):
    # hold the answers to the exact neighbours, not to each other
    gt = np.argsort(((query[:, None] - base[None, : 2 * N_SHARD]) ** 2).sum(-1),
                    axis=1)[:, :1]
    c1, j_c1 = np.mean(ids[:, :1] == gt), np.mean(j_ids[:, :1] == gt)
    assert abs(c1 - j_c1) <= 0.03, (c1, j_c1)
    g.close()
