"""The plain reference: exact k-nearest neighbours in plain PyTorch, and
the comparison that decides ``correct``.

It imports nothing of the program and takes nothing the program made: it
reads the base and the queries that the harness drew and handed to both
sides, and reads the program's answers only to judge them.

Two measures (a configuration's ``measure``), GGNN's own
(``include/ggnn/cuda_utils/distance.cuh:140-159``):

* ``"euclidean"``: the squared L2 distance ``sum((q - b) ** 2)``;
* ``"cosine"``: ``|1 - q.b / sqrt(|q|^2 |b|^2)|``, and 1 where either
  squared norm is 0.

* :func:`exact_knn`: the exact k nearest, one dense f32 product per block
  of queries, TF32 off (``tf32=True`` is the control: the same computation
  in the nearest precision below, TF32 on the card, inputs rounded to
  TF32's 10-bit mantissa on the CPU).
* :func:`pair_dists`: the distance of each (query, returned id) pair in
  float64: the reference's value of each returned distance.
* :func:`recall_hits`: how many of each row's exact nearest were returned.
* :func:`judge`: the numbers compared, each beside its limit.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

__all__ = ["CHECKS", "MEASURES", "exact_knn", "judge", "pair_dists", "passed",
           "recall_hits"]

# the numbers compared: ``dist_gap`` and ``recall_miss`` against the
# configuration's limits; the two counts are exact comparisons, limit 0
CHECKS = ("dist_gap", "recall_miss", "bad_ids", "dup_rows")
MEASURES = ("euclidean", "cosine")


def _is_cosine(measure: str) -> bool:
    if measure not in MEASURES:
        raise ValueError(f"measure {measure!r}: the reference knows "
                         f"{', '.join(MEASURES)}")
    return measure == "cosine"


def _cosine_(dot: torch.Tensor, a_sq: torch.Tensor, b_sq: torch.Tensor) -> torch.Tensor:
    """``dot`` made, in place, into ``|1 - dot / sqrt(a_sq b_sq)|``, and 1
    where ``a_sq`` or ``b_sq`` (broadcastable to it) is 0."""
    dot.div_((a_sq * b_sq).sqrt_()).neg_().add_(1.0).abs_()
    return dot.masked_fill_(a_sq == 0, 1.0).masked_fill_(b_sq == 0, 1.0)


@contextmanager
def _matmul_precision(tf32: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 explicit mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@torch.no_grad()
def exact_knn(base: torch.Tensor, queries: torch.Tensor, k: int, *,
              measure: str = "euclidean", tf32: bool = False, block: int = 2048):
    """(ids [Q, k] int64, dists [Q, k] f32) of the exact ``k`` nearest base
    rows of each query row under ``measure``, ascending, from one f32
    product ``q.b`` per block of ``block`` queries: squared L2 as ``|q|^2 +
    |b|^2 - 2 q.b``, cosine as ``|1 - q.b / sqrt(|q|^2 |b|^2)|``."""
    cosine = _is_cosine(measure)
    base = base.to(torch.float32)
    b_sq = (base * base).sum(1)
    emulate = tf32 and base.device.type != "cuda"
    b_mat = _round_tf32(base) if emulate else base
    out_i, out_d = [], []
    with _matmul_precision(tf32 and not emulate):
        for lo in range(0, queries.shape[0], block):
            q = queries[lo : lo + block].to(torch.float32)
            q_sq = (q * q).sum(1)
            d = torch.mm(_round_tf32(q) if emulate else q, b_mat.T)
            if cosine:
                _cosine_(d, q_sq[:, None], b_sq[None, :])
            else:
                d.mul_(-2.0).add_(b_sq[None, :]).add_(q_sq[:, None]).clamp_min_(0.0)
            dist, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
            del d
            out_i.append(idx)
            out_d.append(dist)
    return torch.cat(out_i), torch.cat(out_d)


@torch.no_grad()
def pair_dists(base: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
               *, measure: str = "euclidean") -> torch.Tensor:
    """[M, k] float64 distance under ``measure`` of ``queries[m]`` to
    ``base[ids[m, j]]``; inf where the id is outside the base."""
    cosine = _is_cosine(measure)
    n = base.shape[0]
    ok = (ids >= 0) & (ids < n)
    rows = base[ids.clamp(0, n - 1)].to(torch.float64)
    if cosine:
        q = queries.to(torch.float64)
        d = _cosine_(torch.einsum("mkd,md->mk", rows, q), (q * q).sum(-1)[:, None],
                     (rows * rows).sum(-1))
    else:
        diff = rows - queries.to(torch.float64)[:, None, :]
        d = (diff * diff).sum(-1)
    return torch.where(ok, d, torch.full_like(d, float("inf")))


def recall_hits(ids: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Per row, how many of the exact nearest ``gt [M, k]`` are among the
    returned ``ids [M, k]``."""
    return (ids[:, :, None] == gt[:, None, :]).any(axis=2).sum(axis=1)


@torch.no_grad()
def judge(base: torch.Tensor, pool: torch.Tensor, rows: np.ndarray,
          ids: np.ndarray, dists: np.ndarray, limits: dict, *,
          recall: float, measure: str = "euclidean", block: int = 8192) -> dict:
    """The numbers compared over the answers ``ids``, ``dists`` [M, k] to
    the pool rows ``rows`` [M] under ``measure``, each {"value", "limit"}:

    * ``dist_gap``: the widest gap between a returned distance and the
      reference's distance of the returned id, as a share of the larger of
      that reference distance and the median one of all compared pairs
      (a pair at a near-zero distance is not judged by its own size);
    * ``recall_miss``: ``1 - recall``, where ``recall`` is the share of the
      exact nearest (:func:`exact_knn`) that the answers returned, over
      every answer of the run: the seeding, the walk and the build must
      find the true neighbours, not only report true distances;
    * ``bad_ids``: rows with an id outside the base (or a missing one);
    * ``dup_rows``: rows that return one base id twice -- the exact k
      nearest are k distinct points.
    A NaN anywhere reads as an infinite gap."""
    dev = base.device
    n = base.shape[0]
    ref, got = [], []
    bad = dup = 0
    for lo in range(0, len(rows), block):
        i = torch.from_numpy(np.ascontiguousarray(ids[lo : lo + block])).to(dev).long()
        d = torch.from_numpy(np.ascontiguousarray(dists[lo : lo + block])).to(dev)
        q = pool[torch.from_numpy(rows[lo : lo + block]).to(dev).long()]
        in_range = ((i >= 0) & (i < n)).all(1)
        bad += int((~in_range).sum())
        srt = torch.sort(i, dim=1).values
        dup += int(((srt[:, 1:] == srt[:, :-1]).any(1) & in_range).sum())
        ref.append(pair_dists(base, q, i, measure=measure)[in_range])
        got.append(d.to(torch.float64)[in_range])
    ref = torch.cat(ref) if ref else torch.zeros((0, 1), dtype=torch.float64)
    got = torch.cat(got) if got else torch.zeros((0, 1), dtype=torch.float64)
    if ref.numel():
        scale = torch.clamp_min(ref, float(ref.median()))
        gap = (got - ref).abs() / scale
        gap = torch.where(torch.isnan(gap), float("inf"), gap)
        dist_gap = float(gap.max())
    else:
        dist_gap = float("inf")
    return {"dist_gap": {"value": dist_gap, "limit": float(limits["dist_gap"])},
            "recall_miss": {"value": 1.0 - float(recall),
                            "limit": float(limits["recall_miss"])},
            "bad_ids": {"value": bad, "limit": 0},
            "dup_rows": {"value": dup, "limit": 0}}


def passed(checks: dict) -> bool:
    """Every number at or under its limit (a NaN never is)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
