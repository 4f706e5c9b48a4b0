"""Top-k / sorted-merge primitives.

Replacement for the reference's shared-memory ``KBestList`` shift-insert
(include/ggnn/cuda_utils/k_best_list.cuh:29-142) and the CUB segmented
sorts: running top-k state is kept in sorted tensors and merged with
``torch.sort``.

Every sort here is stable, so equal distances keep their input order; the
JAX package's multi-operand ``lax.sort`` gives no such promise, which only
matters on exact distance ties.
"""

from __future__ import annotations

import torch

__all__ = [
    "EMPTY_ID",
    "topk_smallest",
    "merge_topk",
    "sort_by_dist",
    "smallest_k_positions",
]

EMPTY_ID = -1


def sort_by_dist(dists: torch.Tensor, ids: torch.Tensor):
    """Sort (dists, ids) ascending by distance along the last axis."""
    d, order = torch.sort(dists, dim=-1, stable=True)
    return d, torch.gather(ids, -1, order)


def topk_smallest(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Smallest-k entries along the last axis, sorted ascending by distance.

    dists: [..., n] f32 (+inf marks empty slots); ids: [..., n] payload.
    Returns (dists [..., k], ids [..., k]).
    """
    n = dists.shape[-1]
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    d, i = sort_by_dist(dists, ids)
    return d[..., :k], i[..., :k]


def merge_topk(dists_a, ids_a, dists_b, ids_b, k: int):
    """Merge two (not necessarily sorted) candidate sets, keep smallest k.

    Shapes: a=[..., na], b=[..., nb]; returns sorted [..., k].
    """
    d = torch.cat([dists_a, dists_b], dim=-1)
    i = torch.cat([ids_a, ids_b], dim=-1)
    return topk_smallest(d, i, k)


def smallest_k_positions(dists: torch.Tensor, k: int):
    """The ``k`` smallest entries of each row: (dists [B, k], positions
    [B, k]), ascending, equal distances in ascending position order -- the
    order of the JAX package's ``lax.top_k(-d, k)``.

    ``torch.topk`` picks the set (which member of a tie straddling the k-th
    place it keeps is unspecified); a stable sort of the k winners by
    position, then by distance, fixes their order."""
    d, pos = torch.topk(dists, k, dim=-1, largest=False, sorted=False)
    pos, o = torch.sort(pos, dim=-1)
    d = torch.gather(d, -1, o)
    d, o = torch.sort(d, dim=-1, stable=True)
    return d, torch.gather(pos, -1, o)
