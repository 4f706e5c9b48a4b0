"""Approximate nearest-neighbour query via batched best-first search over f32
rows: the row engine, at the reference's memory envelope (graph + base).

Replacement for the reference ``QueryKernel``
(src/ggnn/query/query_layer.cu:39-97): instead of one CUDA block per query
with a shared-memory cache, a whole tile of queries advances in lock step --
seeding is one dense f32 product against the S top-layer starting points,
each step expands several frontier anchors per query, and the slack is
tightened per row (query_layer.cu:58-63). Distances are exact f32
throughout, so the results need no re-rank.

With ``two_phase``, after a quarter of the pop budget the rows whose beams
have converged leave the lock-step sweep: the still active rows are
compacted into smaller tiles and only those continue. The pop sequence of
every row is unchanged, so the results are the single-phase ones.
"""

from __future__ import annotations

import torch

from ggnn_torch.config import DistanceMeasure, GraphConfig
from ggnn_torch.graph import Graph
from ggnn_torch.ops.beam import BeamState, Slack, beam_init, beam_insert
from ggnn_torch.ops.distance import dist_block, squared_norms
from ggnn_torch.ops.traverse import beam_active, best_first_search
from ggnn_torch.query.fused import pad_rows, tile_plan
from ggnn_torch.utils.spans import span

__all__ = ["ann_query"]


def _dynamic_xi(nn1_stats, tau_query, measure):
    """Initial slack + per-step tightening (query_layer.cu:48-63): from the
    *max* 1-NN distance, clamped by the current best distance. Returns
    (xi0, the :class:`Slack` that tightens it)."""
    if measure == DistanceMeasure.Euclidean:
        xi0 = (nn1_stats[1] * nn1_stats[1]) * tau_query * tau_query
    else:
        xi0 = nn1_stats[1] * tau_query
    tau = torch.as_tensor(tau_query, dtype=torch.float32, device=xi0.device)
    return xi0, Slack(xi0, tau, DistanceMeasure(measure))


def _query_cold(q_vecs, nbr0, starting_points, base, base_sq, nn1_stats,
                tau_query, *, width: int, vis_size: int, k_query: int,
                measure: DistanceMeasure, budget: int, pops_per_iter: int,
                fetch_cap_fraction: float, route=None, rows=None):
    """Seed from the starting points and run ``budget`` pops. Returns the
    beam and which rows would still pop. Only the first ``rows`` rows (all
    by default) are seeded; the rest pad the tile and never pop."""
    B = q_vecs.shape[0]
    q_vecs = q_vecs.to(torch.float32)
    q_sq = torch.sum(q_vecs * q_vecs, dim=-1)
    xi0, dyn = _dynamic_xi(nn1_stats, tau_query, measure)
    state = beam_init(B, width, xi0, vis_size, device=q_vecs.device)

    # seed with the S starting points: one dense [B, S] f32 distance tile
    with span("seed"):
        sp = starting_points.long()
        seed_d = dist_block(q_vecs, base[sp], measure, q_sq=q_sq,
                            c_sq=base_sq[sp])
        seed_ids = starting_points.to(torch.int32)[None, :].expand(B, -1)
        no_crit = torch.full((B,), float("inf"), device=q_vecs.device)
        real = (None if rows is None or rows == B
                else torch.arange(B, device=q_vecs.device) < rows)
        state = beam_insert(state, seed_ids, seed_d, real, criteria=no_crit)

    with span("walk"):
        state = best_first_search(
            state, q_vecs, q_sq, nbr0, base, base_sq, None, measure, budget,
            k_best=k_query, dynamic_xi=dyn, pops_per_iter=pops_per_iter,
            fetch_cap_fraction=fetch_cap_fraction, route=route,
        )
    return state, beam_active(state, k_query)


def _query_warm(state, q_vecs, nbr0, base, base_sq, nn1_stats, tau_query, *,
                k_query: int, measure: DistanceMeasure, budget: int,
                pops_per_iter: int, fetch_cap_fraction: float, route=None):
    """Resume an existing beam for the remaining pop budget."""
    q_vecs = q_vecs.to(torch.float32)
    q_sq = torch.sum(q_vecs * q_vecs, dim=-1)
    _, dyn = _dynamic_xi(nn1_stats, tau_query, measure)
    with span("walk"):
        return best_first_search(
            state, q_vecs, q_sq, nbr0, base, base_sq, None, measure, budget,
            k_best=k_query, dynamic_xi=dyn, pops_per_iter=pops_per_iter,
            fetch_cap_fraction=fetch_cap_fraction, warm=True, route=route,
        )


@torch.no_grad()
def ann_query(
    query: torch.Tensor,
    base: torch.Tensor,
    graph: Graph,
    cfg: GraphConfig,
    KQuery: int,
    tau_query: float,
    max_iterations: int = 400,
    measure: DistanceMeasure = DistanceMeasure.Euclidean,
    *,
    base_sq: torch.Tensor | None = None,
    chunk: int = 8192,
    pops_per_iter: int = 8,
    fetch_cap_fraction: float = 0.75,
    two_phase: bool = False,
    route=None,
):
    """Query one graph shard.

    Returns (ids [Q, KQuery] int32 shard-local, dists [Q, KQuery] f32 exact),
    each row sorted ascending (-1/inf in unfilled slots), on ``base``'s
    device.

    ``pops_per_iter`` expands that many frontier anchors per step (the total
    pop budget stays ``max_iterations``); 1 reproduces the reference visit
    order exactly. ``fetch_cap_fraction`` bounds each step's vector gather
    after id-dedup (ops/traverse.py). ``two_phase`` compacts converged rows
    out of the sweep after a quarter of the budget (only for Q >= 2048 and a
    budget of at least 8 steps). Queries run in tiles of ``chunk`` rows, the
    last one padded (``query/fused.py:tile_plan``). Each tile is the span
    ``tile[<rows>/<tile rows>]``, its stages the spans ``seed`` (the dense
    seeding product and its insert) and ``walk`` (``utils/spans.py``).
    ``route``: how the walk's loop runs (:mod:`ggnn_torch.utils.graphs`):
    by default as CUDA graphs on the card and eagerly on the CPU;
    ``graphs.EAGER`` is the plain version.
    """
    measure = DistanceMeasure(measure)
    width, vis_size = GraphConfig.query_beam_geometry(KQuery, max_iterations)
    dev = base.device
    if base_sq is None:
        base_sq = squared_norms(base)
    query = query.to(dev)
    starting_points = graph.translation[cfg.L - 1]
    tau = torch.tensor(tau_query, dtype=torch.float32, device=dev)
    nn1_stats = graph.nn1_stats.to(dev)
    nbr0 = graph.neighbors[0]
    P = max(1, pops_per_iter)

    Q = query.shape[0]
    if Q == 0:
        return (torch.zeros((0, KQuery), dtype=torch.int32, device=dev),
                torch.zeros((0, KQuery), dtype=torch.float32, device=dev))
    use_two_phase = two_phase and Q >= 2048 and max_iterations >= 8 * P
    t1 = max_iterations
    if use_two_phase:
        t1 = max(4 * P, (max_iterations // 4 // P) * P)
    t2 = max_iterations - t1
    walk = dict(k_query=KQuery, measure=measure, pops_per_iter=P,
                fetch_cap_fraction=fetch_cap_fraction, route=route)

    states, actives = [], []
    for lo, rows, tile in tile_plan(Q, chunk, dev):
        with span("tile[%d/%d]", rows, tile):
            st, act = _query_cold(
                pad_rows(query[lo : lo + rows], tile), nbr0, starting_points,
                base, base_sq, nn1_stats, tau, width=width, vis_size=vis_size,
                budget=t1, rows=rows, **walk,
            )
            states.append(st.select(slice(0, rows)))
            actives.append(act[:rows])
    state = BeamState(*(torch.cat(xs) for xs in zip(*states)))
    ids, dists = state.best(KQuery)
    if not (use_two_phase and t2 > 0):
        return ids, dists

    # phase 2: compact the still-active rows and spend the remaining budget
    ids, dists = ids.clone(), dists.clone()
    rows = torch.nonzero(torch.cat(actives))[:, 0]
    c2 = min(chunk, 2048)
    for lo in range(0, rows.shape[0], c2):
        sel = rows[lo : lo + c2]
        st = _query_warm(state.select(sel), query[sel], nbr0, base, base_sq,
                         nn1_stats, tau, budget=t2, **walk)
        ids[sel], dists[sel] = st.best(KQuery)
    return ids, dists
