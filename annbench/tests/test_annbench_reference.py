"""The plain reference against NumPy, and the comparison on canned
answers."""

import numpy as np
import pytest
import torch

from annbench import reference

LIMITS = {"dist_gap": 1e-3, "recall_miss": 0.2}


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,d,q,k", [(3000, 96, 200, 10), (777, 17, 65, 25)])
def test_exact_knn_equals_numpy_brute_force(n, d, q, k):
    rng = np.random.default_rng(n)
    base, queries = _unit(rng, n, d), _unit(rng, q, d)
    ids, dists = reference.exact_knn(torch.from_numpy(base),
                                     torch.from_numpy(queries), k, block=64)
    full = ((queries[:, None, :].astype(np.float64) - base[None]) ** 2).sum(-1)
    want = np.argsort(full, axis=1, kind="stable")[:, :k]
    assert (ids.numpy() == want).mean() > 0.999  # f32 may swap a near tie
    np.testing.assert_allclose(dists.numpy(), np.take_along_axis(full, want, 1),
                               rtol=1e-4, atol=1e-5)
    assert (np.diff(dists.numpy(), axis=1) >= 0).all()


def test_pair_dists_are_float64_and_mark_outside_ids():
    base = torch.tensor([[0.0, 0.0], [3.0, 4.0]])
    q = torch.tensor([[0.0, 0.0]])
    d = reference.pair_dists(base, q, torch.tensor([[1, 0, -1, 2]]))
    assert d.dtype == torch.float64
    assert d.tolist() == [[25.0, 0.0, float("inf"), float("inf")]]


def _canned():
    rng = np.random.default_rng(1)
    base = torch.from_numpy(rng.normal(size=(500, 16)).astype(np.float32))
    pool = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32))
    ids, dists = reference.exact_knn(base, pool, 5)
    return base, pool, np.arange(40), ids.numpy(), dists.numpy()


def test_judge_passes_the_exact_answers_and_reads_each_fault():
    base, pool, rows, ids, dists = _canned()
    checks = reference.judge(base, pool, rows, ids, dists, LIMITS, recall=1.0, block=16)
    assert list(checks) == list(reference.CHECKS)
    assert checks["dist_gap"]["value"] < 1e-5 and reference.passed(checks)
    wrong = ids.copy()
    wrong[3, 2] = (wrong[3, 2] + 1) % 500   # an answer altered
    c = reference.judge(base, pool, rows, wrong, dists, LIMITS, recall=1.0)
    assert c["dist_gap"]["value"] > 1e-2
    missing = ids.copy()
    missing[7, 4] = -1
    c = reference.judge(base, pool, rows, missing, dists, LIMITS, recall=1.0)
    assert c["bad_ids"]["value"] == 1 and not reference.passed(c)
    twice = ids.copy()
    twice[9, 1] = twice[9, 0]
    twice_d = dists.copy()
    twice_d[9, 1] = twice_d[9, 0]
    c = reference.judge(base, pool, rows, twice, twice_d, LIMITS, recall=1.0)
    assert c["dup_rows"]["value"] == 1 and not reference.passed(c)
    nan = dists.copy()
    nan[0, 0] = np.nan
    c = reference.judge(base, pool, rows, ids, nan, LIMITS, recall=1.0)
    assert c["dist_gap"]["value"] == float("inf") and not reference.passed(c)
    c = reference.judge(base, pool, rows, ids, dists, LIMITS, recall=0.75)
    assert c["recall_miss"] == {"value": 0.25, "limit": 0.2} and not reference.passed(c)
    c = reference.judge(base, pool, rows, ids, dists, LIMITS, recall=0.85)
    assert reference.passed(c)


def test_the_gap_is_a_share_of_the_larger_of_the_distance_and_the_median():
    base = torch.tensor([[1.0, 0.0], [2.0, 0.0], [3.0, 0.0]])
    pool = torch.tensor([[0.0, 0.0]])
    ids = np.array([[0, 1, 2]])
    # reference distances 1, 4, 9: median 4; errors 0.4 on the first, 0.9 on
    # the last -> 0.4 / max(1, 4) = 0.1, 0.9 / 9 = 0.1
    dists = np.array([[1.4, 4.0, 9.9]], dtype=np.float32)
    c = reference.judge(base, pool, np.array([0]), ids, dists, LIMITS, recall=1.0)
    gap = c["dist_gap"]["value"]
    assert gap == pytest.approx(0.1, rel=1e-6)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -11])
    assert reference._round_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9]
