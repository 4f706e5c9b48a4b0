"""Merge: rebuild a layer's neighbourhoods by searching it.

Replacement for the reference ``MergeKernel``
(src/ggnn/construction/merge_layer.cu:63-158) in its dense-seed form: every
node of ``layer_btm`` is seeded with the distance-nearest representatives of
layer ``layer_btm+1`` (one dense f32 scan per chunk) plus itself, walks
``layer_btm`` through the quantized adjacency (the same walk and kernel as
the query engine), and writes its best KBuild neighbours minus its own
self-link. On layer 0 the 1-NN distance is recorded for the nn1 statistics.

Every chunk reads the same pre-merge graph and writes a fresh output, the
equivalent of the reference's double buffer (graph_construction.cu:292-295).

The reference's hierarchic descent (``dense_seed_merge=False``) is not
ported yet (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import torch

from ggnn_torch.config import MERGE_MAX_ITERATIONS, DistanceMeasure, GraphConfig
from ggnn_torch.ops.beam import beam_init, beam_insert
from ggnn_torch.ops.distance import dist_block
from ggnn_torch.ops.topk import smallest_k_positions
from ggnn_torch.ops.traverse import gather_dists
from ggnn_torch.query.fused import AdjacencyTables, fused_best_first_compacted

__all__ = ["merge_layer"]


def _merge_chunk(n, base, base_sq, trans_btm, nn1_stats, tau_build, adj,
                 reps, *, cfg: GraphConfig, measure: DistanceMeasure,
                 pops_per_iter: int, num_seeds: int):
    B = n.shape[0]
    dev = n.device
    KBuild = cfg.KBuild
    width, vis_size = cfg.merge_beam_geometry()
    k_best = KBuild + 1  # merge_layer.cuh:40: BEST holds KBuild+1 (self + K)

    # slack (merge_layer.cu:74-76): mean 1-NN distance scaled by tau_build
    if measure == DistanceMeasure.Euclidean:
        xi = (nn1_stats[0] * nn1_stats[0]) * tau_build * tau_build
    else:
        xi = nn1_stats[0] * tau_build

    m = trans_btm[n].long() if trans_btm is not None else n.long()
    q_vecs = base[m].to(torch.float32)
    q_sq = base_sq[m]
    state = beam_init(B, width, xi, vis_size, device=dev)

    # dense seeding: the best ``num_seeds`` representatives of layer
    # btm+1 (exact top-k) enter the beam directly
    rep_local, rep_vecs, rep_sq = reps
    seed_d_all = dist_block(q_vecs, rep_vecs, measure, q_sq=q_sq, c_sq=rep_sq)
    seed_d, pos = smallest_k_positions(seed_d_all, min(num_seeds, rep_vecs.shape[0]))
    seed_ids = rep_local[pos]
    # a node that is itself a representative would enter twice (seed + own
    # insert below), breaking beam_insert's unique-ids contract
    dup = seed_ids == n[:, None]
    seed_ids = torch.where(dup, -1, seed_ids)
    seed_d = torch.where(dup, float("inf"), seed_d)
    no_crit = torch.full((B,), float("inf"), device=dev)
    state = beam_insert(state, seed_ids, seed_d, criteria=no_crit)
    d_own, _ = gather_dists(q_vecs, q_sq, n[:, None], base, base_sq, trans_btm,
                            measure)
    state = beam_insert(state, n[:, None], d_own, criteria=no_crit)

    best_i, best_d = fused_best_first_compacted(
        state, q_vecs, q_sq, adj, measure, MERGE_MAX_ITERATIONS,
        k_best=k_best, pops_per_iter=pops_per_iter,
    )

    # write-out with self-link removal (merge_layer.cu:123-145)
    own_eq = best_i[:, :KBuild] == n[:, None]
    own_found = torch.any(own_eq, dim=-1)
    own_pos = torch.where(own_found, torch.argmax(own_eq.to(torch.uint8), dim=-1), -1)
    k = torch.arange(KBuild, device=dev)[None, :]
    shift = (k >= own_pos[:, None]).to(torch.int64)
    out = torch.gather(best_i, -1, k + shift)
    out = torch.where(out == -1, n[:, None], out)

    # 1-NN distance for layer 0 (merge_layer.cu:147-157): first nonzero best
    # distance after the node's own entry
    idx = torch.arange(best_d.shape[-1], device=dev)[None, :]
    cand = (idx > own_pos[:, None]) & (best_d != 0.0)
    found = torch.any(cand, dim=-1)
    first = torch.argmax(cand.to(torch.uint8), dim=-1)
    nn1 = torch.where(found, torch.gather(best_d, -1, first[:, None])[:, 0], 0.0)
    if measure == DistanceMeasure.Euclidean:
        nn1 = torch.sqrt(nn1)
    nn1 = torch.where(torch.isfinite(nn1), nn1, 0.0)
    return out, nn1


@torch.no_grad()
def merge_layer(
    base: torch.Tensor,
    base_sq: torch.Tensor,
    selection: tuple,
    translation: tuple,
    nn1_stats: torch.Tensor,
    cfg: GraphConfig,
    layer_top: int,
    layer_btm: int,
    measure: DistanceMeasure,
    tau_build: float,
    adj: AdjacencyTables,
    chunk: int = 8192,
    pops_per_iter: int = 8,
    num_seeds: int = 32,
):
    """Rebuild ``layer_btm`` neighbourhoods (dense-seed merge).

    ``adj`` is the quantized adjacency of ``layer_btm`` as it stands before
    the merge. Returns (new_neighbors [Ns[layer_btm], KBuild],
    nn1 [Ns[layer_btm]]).
    """
    if layer_top <= layer_btm:
        raise ValueError(f"merge needs layer_top > layer_btm, got "
                         f"{layer_top} -> {layer_btm}")
    dev = base.device
    sel = selection[layer_btm + 1]  # layer_btm-local ids of the reps
    tr = translation[layer_btm + 1].long()  # their base ids
    reps = (sel, base[tr].to(torch.float32), base_sq[tr])
    trans_btm = translation[layer_btm] if layer_btm else None
    tau = torch.tensor(tau_build, dtype=torch.float32, device=dev)
    Ns = cfg.Ns[layer_btm]
    rows, nn1s = [], []
    for start in range(0, Ns, chunk):
        n = torch.arange(start, min(start + chunk, Ns), dtype=torch.int32,
                         device=dev)
        r, d = _merge_chunk(
            n, base, base_sq, trans_btm, nn1_stats, tau, adj, reps, cfg=cfg,
            measure=DistanceMeasure(measure), pops_per_iter=pops_per_iter,
            num_seeds=num_seeds,
        )
        rows.append(r)
        nn1s.append(d)
    return torch.cat(rows), torch.cat(nn1s)
