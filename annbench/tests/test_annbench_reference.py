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


def _cosine_f64(queries: np.ndarray, base: np.ndarray) -> np.ndarray:
    """GGNN's cosine distance in float64: |1 - q.b / sqrt(|q|^2 |b|^2)|, 1
    where either squared norm is 0."""
    q, b = queries.astype(np.float64), base.astype(np.float64)
    q_sq, b_sq = (q * q).sum(1), (b * b).sum(1)
    norm = q_sq[:, None] * b_sq[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.abs(1.0 - (q @ b.T) / np.sqrt(norm))
    return np.where((q_sq[:, None] == 0) | (b_sq[None, :] == 0), 1.0, d)


def _cosine_data(rng, n, d, q):
    """Rows of different norms, with zero rows (distance 1 to everything) and
    exact ties: a row and its double are at one cosine distance."""
    base = (rng.normal(size=(n, d)) * rng.uniform(0.1, 10.0, size=(n, 1))).astype(np.float32)
    queries = (rng.normal(size=(q, d)) * rng.uniform(0.1, 10.0, size=(q, 1))).astype(np.float32)
    base[n // 3 : n // 3 + 3] = 0.0
    base[n - n // 4 :] = 2.0 * base[: n // 4]  # exact ties in f32 as in float64
    queries[0] = 0.0
    queries[1] = base[5]                    # distance 0 to base[5], tied with its double
    return base, queries


@pytest.mark.parametrize("n,d,q,k", [(3000, 96, 200, 10), (777, 17, 65, 25), (512, 960, 33, 10)])
@pytest.mark.parametrize("block", [64, 2048])
def test_cosine_exact_knn_equals_a_float64_brute_force(n, d, q, k, block):
    rng = np.random.default_rng(n + d)
    base, queries = _cosine_data(rng, n, d, q)
    ids, dists = reference.exact_knn(torch.from_numpy(base), torch.from_numpy(queries), k,
                                     measure="cosine", block=block)
    ids, dists = ids.numpy(), dists.numpy()
    full = _cosine_f64(queries, base)
    kth = np.sort(full, axis=1)[:, k - 1]
    np.testing.assert_allclose(dists, np.sort(full, axis=1)[:, :k], rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(np.take_along_axis(full, ids, 1), dists, rtol=1e-5, atol=2e-6)
    assert (np.diff(dists, axis=1) >= 0).all()
    assert all(len(set(r)) == k for r in ids)
    # every base row clearly nearer than the k-th distance is returned
    for row, want in zip(ids, full < (kth - 1e-5)[:, None]):
        assert set(np.nonzero(want)[0]) <= set(row)
    assert (dists[0] == 1.0).all()                      # a zero query
    assert dists[1, 0] == dists[1, 1] and set(ids[1, :2]) == {5, 5 + n - n // 4}
    # and the cosine ranking is not the L2 ranking on such data
    l2 = reference.exact_knn(torch.from_numpy(base), torch.from_numpy(queries), k)[0].numpy()
    assert reference.recall_hits(ids, l2).mean() < 0.9 * k


def test_cosine_pair_dists_are_float64_and_mark_outside_ids():
    base = torch.tensor([[1.0, 0.0], [3.0, 4.0], [0.0, 0.0], [-2.0, 0.0]])
    q = torch.tensor([[2.0, 0.0], [0.0, 0.0]])
    ids = torch.tensor([[0, 1, 2, 3, -1, 4], [0, 1, 2, 3, 0, 1]])
    d = reference.pair_dists(base, q, ids, measure="cosine")
    assert d.dtype == torch.float64
    inf = float("inf")
    assert d.tolist() == [[0.0, 0.4, 1.0, 2.0, inf, inf], [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]]
    rng = np.random.default_rng(3)
    b, qs = _cosine_data(rng, 300, 24, 20)
    i = rng.integers(0, 300, size=(20, 7))
    got = reference.pair_dists(torch.from_numpy(b), torch.from_numpy(qs), torch.from_numpy(i),
                               measure="cosine").numpy()
    np.testing.assert_allclose(got, np.take_along_axis(_cosine_f64(qs, b), i, 1),
                               rtol=1e-13, atol=1e-15)


def test_judge_under_cosine_passes_the_exact_answers_and_reads_each_fault():
    rng = np.random.default_rng(4)
    b, qs = _cosine_data(rng, 600, 24, 48)
    base, pool = torch.from_numpy(b), torch.from_numpy(qs)
    ids, dists = (x.numpy() for x in reference.exact_knn(base, pool, 10, measure="cosine"))
    rows = np.arange(48)

    def judge(i, d=dists):
        return reference.judge(base, pool, rows, i, d, LIMITS, recall=1.0,
                               measure="cosine", block=16)

    checks = judge(ids)
    assert checks["dist_gap"]["value"] < 1e-5 and reference.passed(checks)
    # the same answers judged as squared L2 are far off
    assert not reference.passed(reference.judge(base, pool, rows, ids, dists, LIMITS,
                                                recall=1.0))
    wrong = ids.copy()
    wrong[3, 2] = (wrong[3, 2] + 7) % 600     # an answer altered
    c = judge(wrong)
    assert c["dist_gap"]["value"] > 1e-2 and not reference.passed(c)
    twice = ids.copy()
    twice[9, 1] = twice[9, 0]
    twice_d = dists.copy()
    twice_d[9, 1] = twice_d[9, 0]
    c = judge(twice, twice_d)
    assert c["dup_rows"]["value"] == 1 and not reference.passed(c)
    outside = ids.copy()
    outside[7, 4] = 600
    c = judge(outside)
    assert c["bad_ids"]["value"] == 1 and not reference.passed(c)


@pytest.mark.parametrize("call", ["exact_knn", "pair_dists", "judge"])
def test_an_unknown_measure_is_refused(call):
    base, pool, rows, ids, dists = _canned()
    with pytest.raises(ValueError, match="measure"):
        if call == "exact_knn":
            reference.exact_knn(base, pool, 5, measure="inner_product")
        elif call == "pair_dists":
            reference.pair_dists(base, pool, torch.from_numpy(ids), measure="l2")
        else:
            reference.judge(base, pool, rows, ids, dists, LIMITS, recall=1.0,
                            measure="Cosine")
