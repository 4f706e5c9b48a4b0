"""Batched best-first graph traversal over f32 rows (the row engine's walk).

Replacement for the reference's per-block traversal loops
(src/ggnn/query/query_layer.cu:57-79, src/ggnn/construction/merge_layer.cu:
100-121): a loop over a whole batch of rows, where each step pops P anchors
per row from the flagged beam, gathers their neighbour rows, dedups candidate
ids, gathers the surviving candidates' f32 vectors, computes their distances
to the per-row query, and sorted-merges the admitted candidates back into the
beam. Rows converge independently via masks; the loop runs on the host and
ends once every row is done (one ``bool(active.any())`` sync per step) or at
the ``max_iterations`` pop budget.
"""

from __future__ import annotations

from typing import Callable

import torch

from ggnn_torch.config import DistanceMeasure
from ggnn_torch.ops.beam import (
    BeamState,
    beam_compact_candidates,
    beam_dedup_mask,
    beam_insert,
    beam_pop,
)
from ggnn_torch.ops.distance import dist_gathered

__all__ = ["gather_dists", "seed_beam", "best_first_search", "beam_active"]


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


def seed_beam(
    state: BeamState,
    q_vecs: torch.Tensor,
    q_sq: torch.Tensor,
    seed_ids: torch.Tensor,
    base: torch.Tensor,
    base_sq: torch.Tensor,
    translation: torch.Tensor | None,
    measure: DistanceMeasure,
    valid: torch.Tensor | None = None,
) -> BeamState:
    """Insert starting points unconditionally (the batched
    ``fetch_unfiltered``)."""
    ok = beam_dedup_mask(state, seed_ids, valid)
    seed_ids = torch.where(ok, seed_ids, -1).to(torch.int32)
    d, _ = gather_dists(q_vecs, q_sq, seed_ids, base, base_sq, translation,
                        measure)
    no_crit = torch.full((state.batch,), float("inf"), device=q_vecs.device)
    return beam_insert(state, seed_ids, d, criteria=no_crit)


def best_first_search(
    state: BeamState,
    q_vecs: torch.Tensor,
    q_sq: torch.Tensor,
    nbr_table: torch.Tensor,
    base: torch.Tensor,
    base_sq: torch.Tensor,
    translation: torch.Tensor | None,
    measure: DistanceMeasure,
    max_iterations: int,
    k_best: int,
    dynamic_xi: Callable[[BeamState], torch.Tensor] | None = None,
    pops_per_iter: int = 1,
    fetch_cap_fraction: float = 0.5,
    warm: bool = False,
) -> BeamState:
    """Run the best-first expansion loop until convergence.

    Args:
      state: seeded beam state.
      q_vecs/q_sq: [B, D]/[B] per-row query vectors and squared norms.
      nbr_table: [N_layer, K] int32 neighbour lists of the layer searched.
      translation: optional [N_layer] layer->base id map.
      max_iterations: total anchor-pop budget (MAX_ITERATIONS=200 for merge,
        user max_iterations for query), whatever ``pops_per_iter`` is.
      k_best: size of the logical best list feeding the stopping criterion
        ``d[k_best-1] + xi`` (KQuery for queries, KBuild+1 for merge).
      dynamic_xi: optional per-step slack update (query_layer.cu:58-63).
      pops_per_iter: anchors expanded per step. 1 reproduces the reference
        visit order exactly; >1 shortens the sequential loop by that factor
        and widens each step's distance tile.
      fetch_cap_fraction: after id-dedup, candidates are packed left and the
        vector gather is capped at this fraction of the raw tile (the
        reference's fetch also filters known ids before computing any
        distance, simple_knn_cache.cuh:246-261). Survivors beyond the cap are
        dropped (costs a revisit at most). The first two expansions always
        run uncapped: with an empty beam nearly every candidate survives.
      warm: set when resuming an already-expanded beam (skips the uncapped
        first expansions).
    """
    K = nbr_table.shape[-1]
    P = max(1, pops_per_iter)
    steps = -(-max_iterations // P)
    if P == 1 or fetch_cap_fraction >= 1.0:
        cap = P * K
    else:
        cap = min(P * K, max(K, int(P * K * fetch_cap_fraction + 7) // 8 * 8))

    def step(st, cap_now):
        if dynamic_xi is not None:
            st = st._replace(xi=dynamic_xi(st))
        anchors, active, st = beam_pop(st, P, k_best)  # [B, P]
        B = anchors.shape[0]
        nbrs = nbr_table[anchors.clamp_min(0).long()].reshape(B, P * K)
        valid = (anchors != -1).repeat_interleave(K, dim=-1)
        # dedup on ids BEFORE fetching vectors, then compact the survivors
        ok = beam_dedup_mask(st, nbrs, valid)
        cand = beam_compact_candidates(nbrs, ok, cap_now)
        d, _ = gather_dists(q_vecs, q_sq, cand, base, base_sq, translation,
                            measure)
        st = beam_insert(st, cand, d, row_mask=active,
                         criteria=st.criteria(k_best))
        return st, active

    if cap < P * K and not warm:
        state, _ = step(state, P * K)
        state, _ = step(state, P * K)
        steps = max(0, steps - 2)
    for _ in range(steps):
        state, active = step(state, cap)
        if not bool(active.any()):
            break
    return state


def beam_active(state: BeamState, k_best: int) -> torch.Tensor:
    """Whether the next pop of each row would still fire ([B] bool)."""
    crit = state.criteria(k_best)
    return torch.any(
        ~state.exp & (state.i != -1) & (state.d < crit[:, None]), dim=-1
    )
