"""Merge: rebuild a layer's neighbourhoods by searching down from a top layer.

Replacement for the reference ``MergeKernel``
(src/ggnn/construction/merge_layer.cu:63-158). Every node of ``layer_btm``
is seeded, walks the graph, and writes its best KBuild neighbours minus its
own self-link; on layer 0 the 1-NN distance is recorded for the nn1
statistics. Two seedings:

  * dense (``dense_seed=True``): the distance-nearest representatives of
    layer ``layer_btm+1`` (one dense f32 scan per chunk) plus the node
    itself enter the beam, and only ``layer_btm`` is walked;
  * the reference's hierarchic descent: the node's top-layer segment seeds
    the beam, which descends layer by layer (ids remapped through
    ``selection``), walking each layer, and fetches the node itself at
    ``layer_btm`` (merge_layer.cu:86-121).

A layer with an entry in ``adjs`` is walked through its quantized adjacency
(the query engine's walk and kernel); one without is walked on exact f32
rows (``ops/traverse.py``).

Every chunk reads the same pre-merge graph and writes a fresh output, the
equivalent of the reference's double buffer (graph_construction.cu:292-295).
"""

from __future__ import annotations

import torch

from ggnn_torch.config import MERGE_MAX_ITERATIONS, DistanceMeasure, GraphConfig
from ggnn_torch.ops.beam import beam_init, beam_insert, beam_transform
from ggnn_torch.ops.distance import dist_block
from ggnn_torch.ops.topk import smallest_k_positions
from ggnn_torch.ops.traverse import best_first_search, gather_dists, seed_beam
from ggnn_torch.query.fused import fused_best_first, fused_best_first_compacted

__all__ = ["merge_layer"]


def _top_seg_offset(n, layer_top, layer_btm, cfg: GraphConfig):
    """Start of the top-layer segment covering node ``n`` of ``layer_btm``
    (merge_layer.cu:40-61)."""
    if layer_btm == 0:
        offset_points = cfg.S0_off * (cfg.S0 + 1)
        seg_btm = torch.where(
            n < offset_points,
            n // (cfg.S0 + 1),
            cfg.S0_off + (n - offset_points) // cfg.S0,
        )
    else:
        seg_btm = n // cfg.S
    powG = cfg.G ** (layer_top - layer_btm)
    return (seg_btm // powG) * cfg.S


def _merge_chunk(n, base, base_sq, neighbors, selection, translation,
                 nn1_stats, tau_build, adjs, reps, *, cfg: GraphConfig,
                 layer_top: int, layer_btm: int, measure: DistanceMeasure,
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

    trans_btm = translation[layer_btm] if layer_btm else None
    m = trans_btm[n].long() if trans_btm is not None else n.long()
    q_vecs = base[m].to(torch.float32)
    q_sq = base_sq[m]
    state = beam_init(B, width, xi, vis_size, device=dev)
    no_crit = torch.full((B,), float("inf"), device=dev)

    if reps is not None:
        # dense seeding: the best ``num_seeds`` representatives of layer
        # btm+1 (exact top-k) enter the beam directly
        rep_local, rep_vecs, rep_sq = reps
        seed_d_all = dist_block(q_vecs, rep_vecs, measure, q_sq=q_sq, c_sq=rep_sq)
        seed_d, pos = smallest_k_positions(
            seed_d_all, min(num_seeds, rep_vecs.shape[0]))
        seed_ids = rep_local[pos]
        # a node that is itself a representative would enter twice (seed +
        # own insert below), breaking beam_insert's unique-ids contract
        dup = seed_ids == n[:, None]
        seed_ids = torch.where(dup, -1, seed_ids)
        seed_d = torch.where(dup, float("inf"), seed_d)
        state = beam_insert(state, seed_ids, seed_d, criteria=no_crit)
        d_own, _ = gather_dists(q_vecs, q_sq, n[:, None], base, base_sq,
                                trans_btm, measure)
        state = beam_insert(state, n[:, None], d_own, criteria=no_crit)
        descent_layers = [layer_btm]
    else:
        # seed with the node's top-layer segment (merge_layer.cu:86-97)
        s_offset = _top_seg_offset(n, layer_top, layer_btm, cfg)
        seeds = s_offset[:, None] + torch.arange(cfg.S, dtype=torch.int32,
                                                 device=dev)[None, :]
        state = seed_beam(state, q_vecs, q_sq, seeds, base, base_sq,
                          translation[layer_top], measure)
        descent_layers = list(range(layer_top - 1, layer_btm - 1, -1))

    # hierarchic descent (merge_layer.cu:100-121)
    best = None
    for layer in descent_layers:
        if reps is None:
            state = beam_transform(state, selection[layer + 1], keep=k_best)
        trans_l = translation[layer] if layer else None
        if layer == layer_btm and reps is None:
            # fetch the node itself (merge_layer.cu:103-104). A node that is
            # a representative has descended onto itself already: that copy
            # is dropped, so the beam holds the node once (the JAX package
            # holds it twice and writes a self-link into one slot)
            held = state.i == n[:, None]
            state = state._replace(i=torch.where(held, -1, state.i),
                                   d=torch.where(held, float("inf"), state.d))
            d_own, _ = gather_dists(q_vecs, q_sq, n[:, None], base, base_sq,
                                    trans_l, measure)
            state = beam_insert(state, n[:, None], d_own, criteria=no_crit)
        adj_l = adjs[layer] if adjs is not None else None
        if adj_l is None:
            state = best_first_search(
                state, q_vecs, q_sq, neighbors[layer], base, base_sq, trans_l,
                measure, MERGE_MAX_ITERATIONS, k_best=k_best,
                pops_per_iter=pops_per_iter,
            )
        elif layer == layer_btm:
            # final leg: rows run to convergence, so converged-row
            # compaction pays off; only the k_best prefix is needed
            best = fused_best_first_compacted(
                state, q_vecs, q_sq, adj_l, measure, MERGE_MAX_ITERATIONS,
                k_best=k_best, pops_per_iter=pops_per_iter,
            )
        else:
            state = fused_best_first(
                state, q_vecs, q_sq, adj_l, measure, MERGE_MAX_ITERATIONS,
                k_best=k_best, pops_per_iter=pops_per_iter,
            )
    best_i, best_d = state.best(k_best) if best is None else best

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
    neighbors: tuple,
    selection: tuple,
    translation: tuple,
    nn1_stats: torch.Tensor,
    cfg: GraphConfig,
    layer_top: int,
    layer_btm: int,
    measure: DistanceMeasure,
    tau_build: float,
    chunk: int = 8192,
    pops_per_iter: int = 8,
    adjs: tuple | None = None,
    dense_seed: bool = False,
    num_seeds: int = 32,
):
    """Rebuild ``layer_btm`` neighbourhoods by searching down from
    ``layer_top``.

    ``neighbors``/``selection``/``translation``: the graph's per-layer
    tensors as they stand before the merge. ``adjs``: per-layer quantized
    adjacency (``AdjacencyTables``) or None entries; a layer without one is
    walked on f32 rows. ``dense_seed``: see the module docstring; it enters
    the ``num_seeds`` nearest representatives.

    Returns (new_neighbors [Ns[layer_btm], KBuild], nn1 [Ns[layer_btm]]).
    """
    if layer_top <= layer_btm:
        raise ValueError(f"merge needs layer_top > layer_btm, got "
                         f"{layer_top} -> {layer_btm}")
    dev = base.device
    reps = None
    if dense_seed:
        sel = selection[layer_btm + 1]  # layer_btm-local ids of the reps
        tr = translation[layer_btm + 1].long()  # their base ids
        reps = (sel, base[tr].to(torch.float32), base_sq[tr])
    tau = torch.tensor(tau_build, dtype=torch.float32, device=dev)
    Ns = cfg.Ns[layer_btm]
    rows, nn1s = [], []
    for start in range(0, Ns, chunk):
        n = torch.arange(start, min(start + chunk, Ns), dtype=torch.int32,
                         device=dev)
        r, d = _merge_chunk(
            n, base, base_sq, neighbors, selection, translation, nn1_stats,
            tau, adjs, reps, cfg=cfg, layer_top=layer_top,
            layer_btm=layer_btm, measure=DistanceMeasure(measure),
            pops_per_iter=pops_per_iter, num_seeds=num_seeds,
        )
        rows.append(r)
        nn1s.append(d)
    return torch.cat(rows), torch.cat(nn1s)
