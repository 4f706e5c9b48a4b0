"""Recall / consistency evaluation against ground truth.

Port of the reference ``Evaluator`` semantics (src/ggnn/base/eval.cpp:88-242,
include/ggnn/base/eval.h:39-48), vectorized with NumPy.

Metrics (all averaged over queries):
  * ``c1``       -- top-1 result id equals top-1 ground-truth id.
  * ``c1_dup``   -- top-1 result id is any ground-truth id whose distance ties
                    the top-1 distance (within 1e-6).
  * ``cKQuery``  -- fraction of result ids found in the top-KQuery ground
                    truth (averaged over all N*K result slots).
  * ``cKQuery_dup`` -- same, extending the ground-truth prefix by distance
                    ties at position KQuery.
  * ``rKQuery``  -- top-1 ground-truth id found anywhere in the result row.
  * ``rKQuery_dup`` -- identical to rKQuery (kept for reference parity:
                    eval.cpp:207-212 increments both on the same condition).

NOTE: the reference's CPU-side cosine distance has a bug -- ``b_norm``
accumulates ``a[d]*a[d]`` (eval.cpp:52). We intentionally do NOT replicate it;
cosine here normalizes by both vectors' norms.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ggnn_torch.config import DistanceMeasure

__all__ = ["Evaluation", "Evaluator"]

_EPSILON = 1e-6


@dataclasses.dataclass
class Evaluation:
    """Result of :meth:`Evaluator.evaluate_results` (eval.h:39-48)."""

    KQuery: int = 0
    c1: float = float("nan")
    c1_dup: float = float("nan")
    cKQuery: float = float("nan")
    cKQuery_dup: float = float("nan")
    rKQuery: float = float("nan")
    rKQuery_dup: float = float("nan")

    # snake_case aliases matching the reference Python bindings
    # (nanobind.cu:280-293)
    @property
    def k_query(self):
        return self.KQuery

    @property
    def c_k_query(self):
        return self.cKQuery

    @property
    def c_k_query_dup(self):
        return self.cKQuery_dup

    @property
    def r_k_query(self):
        return self.rKQuery

    @property
    def r_k_query_dup(self):
        return self.rKQuery_dup

    def __str__(self) -> str:
        def dup(v):
            return f" +duplicates: {v}" if not math.isnan(v) else " (duplicates unknown)"

        return (
            f"c@1 (=r@1): {self.c1}{dup(self.c1_dup)}\n"
            f"c@{self.KQuery}: {self.cKQuery}{dup(self.cKQuery_dup)}\n"
            f"r@{self.KQuery}: {self.rKQuery}{dup(self.rKQuery_dup)}"
        )

    __repr__ = __str__


def _cpu_distances(base_rows: np.ndarray, query: np.ndarray, measure) -> np.ndarray:
    """Distance of each gathered base row to its query (eval.cpp:38-65).

    base_rows: [Q, K, D]; query: [Q, D]. Euclidean uses sqrt here (unlike the
    device kernels) to match the reference's CPU-side tie detection.
    """
    base_rows = base_rows.astype(np.float64)
    query = query.astype(np.float64)
    if measure == DistanceMeasure.Euclidean:
        diff = base_rows - query[:, None, :]
        return np.sqrt(np.einsum("qkd,qkd->qk", diff, diff)).astype(np.float32)
    dot = np.einsum("qkd,qd->qk", base_rows, query)
    b_norm = np.einsum("qkd,qkd->qk", base_rows, base_rows)
    q_norm = np.einsum("qd,qd->q", query, query)
    norm_sq = b_norm * q_norm[:, None]
    safe = norm_sq > 0.0
    with np.errstate(invalid="ignore", divide="ignore"):
        d = np.abs(1.0 - dot / np.sqrt(np.where(safe, norm_sq, 1.0)))
    return np.where(safe, d, 1.0).astype(np.float32)


class Evaluator:
    """Computes recall metrics of ANN results vs brute-force ground truth.

    Signature mirrors the reference bindings (nanobind.cu:270-278):
    ``Evaluator(base, query, gt, k_query, measure)``. ``base``/``query`` are
    optional for duplicate detection -- without them, only the non-duplicate
    metrics are produced (eval.cpp:94-103).
    """

    def __init__(
        self,
        base=None,
        query=None,
        gt=None,
        k_query: int = 10,
        measure: DistanceMeasure = DistanceMeasure.Euclidean,
    ):
        if gt is None:
            raise ValueError("ground truth `gt` is required")
        self.KQuery = int(k_query)
        self.measure = DistanceMeasure(measure)
        self.gt = np.asarray(gt, dtype=np.int32)
        if self.gt.ndim != 2:
            raise ValueError("gt must be [N_query, K_gt]")
        self.top1_duplicate_end: np.ndarray | None = None
        self.topk_duplicate_end: np.ndarray | None = None

        if base is None or query is None:
            return

        base = np.asarray(base)
        query = np.asarray(query)
        nq, kgt = self.gt.shape

        # eval.cpp:135-174 -- find distance ties at positions 0 and KQuery-1.
        gt_vectors = base[self.gt.reshape(-1)].reshape(nq, kgt, -1)
        gt_dists = _cpu_distances(gt_vectors, query, self.measure)  # [nq, kgt]

        # consecutive run of ties following position 0
        tie1 = (gt_dists[:, 1:] - gt_dists[:, :1]) <= _EPSILON  # [nq, kgt-1]
        run1 = np.cumprod(tie1, axis=1).sum(axis=1)
        self.top1_duplicate_end = (1 + run1).astype(np.int32)

        if self.KQuery <= kgt:
            ref = gt_dists[:, self.KQuery - 1 : self.KQuery]
            tiek = (gt_dists[:, self.KQuery :] - ref) <= _EPSILON
            runk = (
                np.cumprod(tiek, axis=1).sum(axis=1)
                if tiek.shape[1]
                else np.zeros(nq, dtype=np.int64)
            )
            self.topk_duplicate_end = (self.KQuery + runk).astype(np.int32)
        else:
            self.topk_duplicate_end = np.full(nq, kgt, dtype=np.int32)

    def evaluate_results(self, results) -> Evaluation:
        """Count ground-truth hits per query row (eval.cpp:176-242)."""
        results = np.asarray(results, dtype=np.int32)
        if results.ndim != 2:
            raise ValueError("results must be [N_query, KQuery]")
        nq = results.shape[0]
        if nq > self.gt.shape[0]:
            raise ValueError("more result rows than ground-truth rows")
        K = self.KQuery
        results = results[:, :K]
        gt = self.gt[:nq]
        kgt = gt.shape[1]

        has_dup = self.top1_duplicate_end is not None
        end_top1 = self.top1_duplicate_end[:nq] if has_dup else np.ones(nq, np.int32)
        end_topk = (
            self.topk_duplicate_end[:nq] if has_dup else np.full(nq, K, np.int32)
        )

        col = np.arange(kgt, dtype=np.int32)[None, :]  # [1, kgt]
        in_topk_mask = col < np.minimum(end_topk, K)[:, None]  # k_gt < KQuery branch
        in_dup_mask = col < end_topk[:, None]
        in_top1_mask = col < end_top1[:, None]

        # membership: match[n, kr, kg] = results[n, kr] == gt[n, kg]
        match = results[:, :, None] == gt[:, None, :]  # [nq, K, kgt]

        c1 = int(np.sum(results[:, 0] == gt[:, 0]))
        c1_dup = int(np.sum(np.any(match[:, 0, :] & in_top1_mask, axis=-1)))
        cK = int(np.sum(match & in_topk_mask[:, None, :]))
        cK_dup = int(np.sum(match & in_dup_mask[:, None, :]))
        rK = int(np.sum(np.any(results == gt[:, :1], axis=1)))

        inv_q = 1.0 / float(nq)
        inv_r = 1.0 / float(nq * K)
        nan = float("nan")
        return Evaluation(
            KQuery=K,
            c1=c1 * inv_q,
            c1_dup=c1_dup * inv_q if has_dup else nan,
            cKQuery=cK * inv_r,
            cKQuery_dup=cK_dup * inv_r if has_dup else nan,
            rKQuery=rK * inv_q,
            rKQuery_dup=rK * inv_q if has_dup else nan,
        )
