"""``seed_approx`` on the port's fused routes.

* ``GGNN.query(engine="fused")`` takes the JAX package's default (True);
  ``fused_query`` and ``sharded_fused_query`` default to False, as there.
* On a 4,096-point base with at least 272 layer-1 representatives (so that
  the reduction at ``num_seeds=8`` has fewer bins than representatives and
  the approximation is real), c@1 with approximate seeds is at least c@1
  with exact seeds minus 0.03: the JAX package's own bound
  (``tests/test_fused.py:test_seed_approx_recall_close``).
* The flag reaches the seeding on every fused route: one slot, two CPU
  slots through the device merge and the host merge, and the out-of-core
  rotation. Calls of the approximate top-k's plain version (the CPU's
  route) are counted: one per shard and tile with the flag, none without.
"""

import inspect

import numpy as np
import pytest
import torch

from ggnn_torch import GGNN, Evaluator
from ggnn_torch.ops import approx_topk
from ggnn_torch.ops.approx_topk import reduction_size
from ggnn_torch.parallel import sharded
from ggnn_torch.query import fused
from torch_reference import one_torch_thread  # noqa: F401

N, D, KB, NQ = 4096, 32, 12, 300
# a budget at which c@1 is ~0.83, not saturated
TAU, ITERS = 0.6, 32
QKW = dict(engine="fused", num_seeds=8, rerank=16, width=32, cap=32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    base = rng.normal(size=(N, D)).astype(np.float32)
    query = rng.normal(size=(NQ, D)).astype(np.float32)
    return base, query


@pytest.fixture(scope="module")
def one_slot(data):
    base, query = data
    g = GGNN(device="cpu")
    g.set_base(base)
    g.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
    g.build_fused_index()
    gt, _ = g.bf_query(query, k_gt=10)
    yield g, Evaluator(base, query, gt, k_query=10)
    g.close()


@pytest.fixture
def seedings(monkeypatch):
    """Counts the calls of the approximate top-k's plain version."""
    calls = []
    plain = approx_topk.approx_smallest_k_plain

    def counted(dists, k, *a, **kw):
        calls.append(tuple(dists.shape))
        return plain(dists, k, *a, **kw)

    monkeypatch.setattr(approx_topk, "approx_smallest_k_plain", counted)
    return calls


def test_defaults_follow_the_jax_package():
    assert GGNN._ENGINE_KWARGS["seed_approx"] == (("fused",), True)
    for fn in (fused.fused_query, sharded.sharded_fused_query):
        assert inspect.signature(fn).parameters["seed_approx"].default is False


def test_recall_close_to_exact_seeds(one_slot, data):
    g, ev = one_slot
    _, query = data
    reps = int(g._shards[0].fused_index.rep_ids.shape[0])
    assert reps >= 272 and reduction_size(reps, QKW["num_seeds"]) < reps
    c1 = {}
    for approx in (False, True):
        ids, _ = g.query(query, 10, TAU, ITERS, seed_approx=approx, **QKW)
        c1[approx] = ev.evaluate_results(ids).c1
    print(f"c@1 exact seeds {c1[False]:.4f}, approximate seeds {c1[True]:.4f} "
          f"({reps} representatives, {reduction_size(reps, 8)} bins)")
    assert c1[True] >= c1[False] - 0.03
    assert 0.5 < c1[False] < 1.0


def test_flag_reaches_the_seeding_on_one_slot(one_slot, data, seedings):
    g, _ = one_slot
    _, query = data
    a, _ = g.query(query, 10, TAU, ITERS, seed_approx=False, **QKW)
    assert seedings == []
    b, _ = g.query(query, 10, TAU, ITERS, **QKW)  # the default
    assert len(seedings) == 1
    reps = int(g._shards[0].fused_index.rep_ids.shape[0])
    assert seedings[0] == (NQ, reps)
    assert a.shape == b.shape


@pytest.mark.parametrize("device_merge", [True, False])
def test_flag_reaches_the_seeding_on_two_slots(data, seedings, device_merge):
    base, query = data
    g = GGNN(device="cpu")
    try:
        g.set_devices(["cpu", "cpu"])
        g.set_base(base)
        g.set_shard_size(N // 2)
        g.set_device_merge(device_merge)
        g.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
        seedings.clear()  # the build's merges seed through it too
        g.build_fused_index()
        g.query(query, 10, TAU, ITERS, seed_approx=False, **QKW)
        assert seedings == []
        g.query(query, 10, TAU, ITERS, seed_approx=True, **QKW)
        assert g.last_merge_route == ("devices" if device_merge else "host")
        assert len(seedings) == 2  # one per slot's shard
    finally:
        g.close()


def test_flag_reaches_the_seeding_through_a_rotation(data, seedings):
    base, query = data
    g = GGNN(device="cpu")
    try:
        g.set_base(base)
        g.set_shard_size(N // 4)
        g.set_max_device_shards(1)
        g.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
        seedings.clear()
        g.build_fused_index()
        g.query(query, 10, TAU, ITERS, seed_approx=False, **QKW)
        assert seedings == []
        g.query(query, 10, TAU, ITERS, seed_approx=True, **QKW)
        assert len(seedings) == 4  # one per rotated shard
        assert g.tier_stats["evictions"] > 0
    finally:
        g.close()


def test_smoke_holds_the_kernel_on_a_paths_own_seeding_inputs(one_slot, data,
                                                              monkeypatch):
    """``chip_smoke.approx_on_real_inputs`` builds a path's seeding inputs
    from its index (each dense-seeded merge's first chunk, each query tile)
    and holds the top-k route against its plain version on them; on the CPU
    both are the plain version, and a route that returns other ids fails."""
    import chip_smoke

    g, _ = one_slot
    q = torch.from_numpy(data[1])
    layers = len(g._shards[0].graph.translation)
    out = chip_smoke.approx_on_real_inputs(torch.device("cpu"), g, q, "a test base")
    # the merges of layers 0 .. L-2, and one tile of the 300 queries
    assert out["inputs"] == layers and out["shards"] == "1 of 1"
    assert out["differing"] == 0 and out["max_ulp"] == 0
    reps = len(g._shards[0].fused_index.rep_ids)
    assert [NQ, reps, 8] in [list(s) for s in out["shapes"]]

    route = approx_topk.approx_smallest_k

    def reversed_ids(*args, **kw):
        d, p = route(*args, **kw)
        return d, p.flip(-1)

    monkeypatch.setattr(approx_topk, "approx_smallest_k", reversed_ids)
    with pytest.raises(AssertionError, match="differs from its plain version"):
        chip_smoke.approx_on_real_inputs(torch.device("cpu"), g, q, "a test base")
