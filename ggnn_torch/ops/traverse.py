"""Row-gather distances (the dense-seed merge's own-distance).

The row engine's best-first loop (``best_first_search``/``seed_beam``) is
not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import torch

from ggnn_torch.config import DistanceMeasure
from ggnn_torch.ops.distance import dist_gathered

__all__ = ["gather_dists"]


def gather_dists(
    q_vecs: torch.Tensor,
    q_sq: torch.Tensor,
    ids: torch.Tensor,
    base: torch.Tensor,
    base_sq: torch.Tensor,
    translation: torch.Tensor | None,
    measure: DistanceMeasure,
):
    """Distances from per-row queries to per-row candidate ids.

    ``ids`` are layer-local ids ([B, K]); ``translation`` (if given) maps them
    to base ids first (merge_layer.cu:118). Invalid ids (-1) produce
    arbitrary distances -- callers mask them.

    Returns (dists [B, K], base_ids [B, K]).
    """
    safe = ids.clamp_min(0).long()
    if translation is not None and translation.shape[0]:
        base_ids = translation[safe].long()
    else:
        base_ids = safe
    vecs = base[base_ids]  # [B, K, D]
    d = dist_gathered(q_vecs, vecs, measure, q_sq=q_sq, cand_sq=base_sq[base_ids])
    return d, base_ids
