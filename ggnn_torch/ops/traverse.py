"""Batched best-first graph traversal over f32 rows (the row engine's walk).

Replacement for the reference's per-block traversal loops
(src/ggnn/query/query_layer.cu:57-79, src/ggnn/construction/merge_layer.cu:
100-121): a loop over a whole batch of rows, where each step pops P anchors
per row from the flagged beam, gathers their neighbour rows, dedups candidate
ids, computes the surviving candidates' distances to the per-row query in
one fused gather + distance (``ops/gather_dist.py``), and sorted-merges the
admitted candidates back into the beam. Rows converge independently via
masks; the loop ends once every row is done or at the ``max_iterations``
pop budget. On the card the capped steps replay as CUDA graphs and the host
reads the live count once per replay (``ggnn_torch/utils/graphs.py``, the
counterpart of the JAX package's ``lax.while_loop``); the eager loop, one
read per step, is the CPU's and the plain version.
"""

from __future__ import annotations

import torch

from ggnn_torch.config import DistanceMeasure
from ggnn_torch.ops.beam import (
    BeamState,
    Slack,
    beam_dedup_compact,
    beam_dedup_mask,
    beam_insert,
    beam_pop,
)
from ggnn_torch.ops.gather_dist import gather_dist
from ggnn_torch.utils import graphs

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

    Returns (dists [B, K], base_ids [B, K]): one pass of the fused gather +
    distance (:func:`ggnn_torch.ops.gather_dist.gather_dist`, the kernel on
    the card), no ``[B, K, D]`` intermediate.
    """
    d, base_ids = gather_dist(q_vecs[:, None], q_sq[:, None], ids, base,
                              base_sq, translation, measure)
    return d[:, 0], base_ids


def candidate_dists(q_vecs, q_sq, ids, base, base_sq, translation, measure):
    """:func:`gather_dists`' distances alone ([B, K]): the walks' steps
    and the merges' own distances, which discard the base ids, so the
    kernel writes none."""
    d, _ = gather_dist(q_vecs[:, None], q_sq[:, None], ids, base, base_sq,
                       translation, measure, with_ids=False)
    return d[:, 0]


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
    d = candidate_dists(q_vecs, q_sq, seed_ids, base, base_sq, translation,
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
    dynamic_xi: Slack | None = None,
    pops_per_iter: int = 1,
    fetch_cap_fraction: float = 0.5,
    warm: bool = False,
    *,
    route: graphs.Route | None = None,
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
      route: how the capped loop runs (:mod:`ggnn_torch.utils.graphs`; by
        default graphs on the card, the eager loop on the CPU).
    """
    K = nbr_table.shape[-1]
    P = max(1, pops_per_iter)
    steps = -(-max_iterations // P)
    if P == 1 or fetch_cap_fraction >= 1.0:
        cap = P * K
    else:
        cap = min(P * K, max(K, int(P * K * fetch_cap_fraction + 7) // 8 * 8))
    route = graphs.resolve(route, q_vecs.device)
    consts = (q_vecs, q_sq)
    if dynamic_xi is not None:
        consts += (dynamic_xi.xi0, dynamic_xi.tau)

    def step(st, c, cap_now=cap):
        if dynamic_xi is not None:
            st = st._replace(xi=Slack(c[2], c[3], dynamic_xi.measure)(st))
        anchors, active, st = beam_pop(st, P, k_best)  # [B, P]
        B = anchors.shape[0]
        nbrs = nbr_table[anchors.clamp_min(0).long()].reshape(B, P * K)
        valid = (anchors != -1)[:, :, None].expand(B, P, K).reshape(B, P * K)
        # dedup on ids BEFORE fetching vectors, and compact the survivors
        _, cand = beam_dedup_compact(st, nbrs, valid, cap_now)
        d = candidate_dists(c[0], c[1], cand, base, base_sq, translation,
                            measure)
        st = beam_insert(st, cand, d, row_mask=active,
                         criteria=st.criteria(k_best))
        return st, active

    if cap < P * K and not warm:
        state, _ = step(state, consts, P * K)
        state, _ = step(state, consts, P * K)
        steps = max(0, steps - 2)
    B = q_vecs.shape[0]
    name = ("row", int(measure), k_best, P, K, cap, dynamic_xi is not None)
    state, *_ = graphs.run_steps(
        step, state, consts, torch.ones((B,), dtype=torch.bool,
                                        device=q_vecs.device),
        it=0, steps=steps, live_n=B, floor=0, route=route, name=name,
        reads=(nbr_table, base, base_sq, translation))
    return state


def beam_active(state: BeamState, k_best: int) -> torch.Tensor:
    """Whether the next pop of each row would still fire ([B] bool)."""
    crit = state.criteria(k_best)
    return torch.any(
        ~state.exp & (state.i != -1) & (state.d < crit[:, None]), dim=-1
    )
