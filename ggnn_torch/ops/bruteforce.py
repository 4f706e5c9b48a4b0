"""Exact (brute-force) k-nearest-neighbor search.

Replacement for the reference's ``BruteForceQueryKernel``
(src/ggnn/query/bf_query_layer.cu:39-65: one CUDA block per query scanning
all base points): a tiled dense f32 distance product with a running top-k
merge. Used as the ground-truth oracle (``GGNN.bf_query``) and by tests.
"""

from __future__ import annotations

import torch

from ggnn_torch.config import DistanceMeasure
from ggnn_torch.ops.distance import dist_block, squared_norms
from ggnn_torch.ops.topk import merge_topk, smallest_k_positions

__all__ = ["bruteforce_knn"]


@torch.no_grad()
def bruteforce_knn(
    base: torch.Tensor,
    query: torch.Tensor,
    k: int,
    measure: DistanceMeasure = DistanceMeasure.Euclidean,
    *,
    tile_base: int = 8192,
    tile_query: int = 16384,
):
    """Exact k-NN of ``query`` rows in ``base`` rows.

    base: [N, D] float32/uint8; query: [Q, D]; k <= N.
    ``tile_base`` x ``tile_query`` bounds the f32 distance tile in memory.
    Returns (ids [Q, k] int32, dists [Q, k] f32), each row sorted ascending;
    equal distances come in ascending id order.
    """
    N = base.shape[0]
    Q = query.shape[0]
    if k > N:
        raise ValueError(f"k={k} > N={N}")
    measure = DistanceMeasure(measure)
    query = query.to(torch.float32)
    q_sq_all = squared_norms(query)
    out_i, out_d = [], []
    for q0 in range(0, Q, tile_query):
        q = query[q0 : q0 + tile_query]
        q_sq = q_sq_all[q0 : q0 + tile_query]
        best_d = torch.full((q.shape[0], k), float("inf"), device=q.device)
        best_i = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=q.device)
        for lo in range(0, N, tile_base):
            tile = base[lo : lo + tile_base].to(torch.float32)
            d = dist_block(q, tile, measure, q_sq=q_sq)
            tile_d, pos = smallest_k_positions(d, min(k, tile.shape[0]))
            tile_i = (pos + lo).to(torch.int32)
            # running best first: on a tie the earlier (lower) id stays ahead
            best_d, best_i = merge_topk(best_d, best_i, tile_d, tile_i, k)
        out_i.append(best_i)
        out_d.append(best_d)
    return torch.cat(out_i), torch.cat(out_d)
