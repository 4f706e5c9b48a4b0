"""Per-segment brute-force kNN seeding ("top merge").

Replacement for the reference ``TopMergeKernel``
(src/ggnn/construction/top_merge_layer.cu:40-89: one CUDA block per point
scanning its segment with a KBestList). Segments are fixed-size and
contiguous, so the whole layer becomes a batch of dense S x S f32 distance
matrices followed by a row sort -- no per-point loops.
"""

from __future__ import annotations

import torch

from ggnn_torch.config import DistanceMeasure, GraphConfig
from ggnn_torch.ops.distance import finish

__all__ = ["top_merge_layer"]


def _top_merge_chunk(seg_ids, base, base_sq, translation, *, W: int, S: int,
                     S_offset: int, KBuild: int, measure: DistanceMeasure):
    dev = seg_ids.device
    C = seg_ids.shape[0]
    if S_offset:
        starts = seg_ids * S + torch.clamp_max(seg_ids, S_offset)
        sizes = S + (seg_ids < S_offset).to(torch.int64)
    else:
        starts = seg_ids * S
        sizes = torch.full((C,), S, dtype=torch.int64, device=dev)

    offs = torch.arange(W, device=dev)[None, :].expand(C, W)
    node_ids = starts[:, None] + offs  # [C, W] layer-local ids
    valid = offs < sizes[:, None]
    safe_nodes = torch.where(valid, node_ids, 0)
    m = translation[safe_nodes].long() if translation is not None else safe_nodes
    vecs = base[m].to(torch.float32)  # [C, W, D]
    sq = base_sq[m]  # [C, W]

    dots = torch.einsum("cwd,cvd->cwv", vecs, vecs)
    d = finish(dots, sq[:, :, None], sq[:, None, :], measure)
    # mask out self matches (incl. translated duplicates,
    # top_merge_layer.cu:66) and padded columns
    self_mask = m[:, :, None] == m[:, None, :]
    d = torch.where(self_mask | ~valid[:, None, :], float("inf"), d)

    sorted_d, sorted_c = torch.sort(d, dim=-1, stable=True)
    # segments narrower than KBuild (the S0 < KBuild regime) leave the row
    # partially filled, like the reference's KBestList; later merges fill it
    take = min(KBuild, W)
    top_d = sorted_d[:, :, :take]
    top_ids = starts[:, None, None] + sorted_c[:, :, :take]
    top_ids = torch.where(torch.isinf(top_d), -1, top_ids)
    if take < KBuild:
        top_ids = torch.nn.functional.pad(top_ids, (0, KBuild - take), value=-1)

    # 1-NN statistic = second-best non-self distance (top_merge_layer.cu:77)
    nn1 = sorted_d[:, :, 1]
    if measure == DistanceMeasure.Euclidean:
        nn1 = torch.sqrt(nn1)
    nn1 = torch.where(torch.isinf(nn1), 0.0, nn1)
    return node_ids, valid, top_ids.to(torch.int32), nn1


@torch.no_grad()
def top_merge_layer(
    base: torch.Tensor,
    base_sq: torch.Tensor,
    translation_l: torch.Tensor | None,
    cfg: GraphConfig,
    layer: int,
    measure: DistanceMeasure,
    seg_chunk: int = 2048,
):
    """Seed ``layer`` with per-segment exact kNN.

    Returns (neighbors [Ns[layer], KBuild] int32 layer-local ids,
             nn1 [Ns[layer]] f32 second-best distances).
    """
    dev = base.device
    S = cfg.layer_segment_size(layer)
    S_offset = cfg.layer_segment_offset_count(layer)
    W = S + (1 if S_offset else 0)
    num_segments = cfg.Bs[layer]
    trans = translation_l if layer > 0 else None
    Ns = cfg.Ns[layer]
    nbrs_out = torch.full((Ns, cfg.KBuild), -1, dtype=torch.int32, device=dev)
    nn1_out = torch.zeros((Ns,), dtype=torch.float32, device=dev)
    for start in range(0, num_segments, seg_chunk):
        ids = torch.arange(start, min(start + seg_chunk, num_segments), device=dev)
        node_ids, valid, top_ids, nn1 = _top_merge_chunk(
            ids, base, base_sq, trans, W=W, S=S, S_offset=S_offset,
            KBuild=cfg.KBuild, measure=DistanceMeasure(measure),
        )
        rows = node_ids[valid]
        nbrs_out[rows] = top_ids[valid]
        nn1_out[rows] = nn1[valid]
    return nbrs_out, nn1_out
