"""Quantized-adjacency ANN query: the port's query engine.

The engine restructures the *memory layout*, not the search semantics:

  * ``blocks [N, KBuild, D] uint8`` stores each point's neighbours' vectors
    inline, quantized per dimension -- ONE contiguous fetch per popped anchor
    yields the vectors of ALL its neighbours;
  * neighbour distances come from a dequant-dot
    (``(q*scale) . codes + q.zero``, the kernel in ``ops/adjacency.py``) --
    no per-candidate gather at all;
  * seeding scores the layer-1 representatives (translation[1], the WRS
    cluster heads the build already selected) against the query tile in one
    dense f32 product, replacing the reference's hierarchy descent
    (query_kernels.cu:149 seeds from translation[L-1]);
  * the best-first walk is the flagged-beam traversal (pop -> expand ->
    filter -> dedup -> insert under ``best + xi``), with the reference's
    dynamic slack tightening (query_layer.cu:58-63);
  * a final exact re-rank gathers f32 rows for only the surviving top
    candidates.

Distances during the walk are exact distances to the *dequantized* points,
so the walk explores the true graph with a slightly perturbed metric, and
the re-rank restores exact ordering.

This slice covers ``group=1`` and ``bits=8``; the walk's neighbour ids and
dequantized squared norms are two plain tensors beside the code blocks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ggnn_torch.config import DistanceMeasure, GraphConfig
from ggnn_torch.graph import Graph
from ggnn_torch.ops.adjacency import adjacency_dot
from ggnn_torch.ops.beam import (
    BeamState,
    beam_dedup_mask,
    beam_init,
    beam_insert,
    beam_pop,
)
from ggnn_torch.ops.distance import dist_block, finish, squared_norms
from ggnn_torch.ops.topk import smallest_k_positions, sort_by_dist

__all__ = [
    "AdjacencyTables",
    "FusedIndex",
    "assemble_fused_index",
    "build_fused_index",
    "encode_u8",
    "fit_affine_u8",
    "fused_best_first",
    "fused_best_first_compacted",
    "fused_query",
    "make_adjacency",
    "match_groups",
]

EMPTY_ID = -1
EMPTY_DIST = float("inf")


class AdjacencyTables(NamedTuple):
    """The quantized-adjacency core of one graph layer, one block per node
    (used by the construction merge; :class:`FusedIndex` adds the seeds)."""

    nbr_ids: torch.Tensor  # [N, K] i32 neighbour ids (-1 = empty)
    blocks: torch.Tensor  # [N, K, D] u8 inline neighbour codes
    nbr_sq: torch.Tensor  # [N, K] f32 dequantized squared norms (inf = empty)
    scale: torch.Tensor  # [D] f32
    zero: torch.Tensor  # [D] f32

    @property
    def cand_per_fetch(self) -> int:
        return self.nbr_ids.shape[1]


class FusedIndex(NamedTuple):
    """Quantized-adjacency index of one shard (device-resident).

    Attributes:
      nbr_ids: [N, K] i32 -- each node's neighbour ids (-1 = empty slot).
      blocks: [N, K, D] u8 -- the fetch unit: the node's neighbours'
        quantized vectors inline.
      nbr_sq: [N, K] f32 -- squared norms of the dequantized neighbours.
      scale / zero: [D] f32 -- per-dimension affine dequantization
        (x_hat = scale * code + zero).
      rep_ids: [R] i32 -- base ids of the layer-1 representatives (seeds).
      rep_vecs: [R, D] f32 -- their vectors (dense seeding scan).
      rep_sq: [R] f32.
      nn1_stats: [2] f32 -- {mean, max} 1-NN distance (slack scaling).
    """

    nbr_ids: torch.Tensor
    blocks: torch.Tensor
    nbr_sq: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    rep_ids: torch.Tensor
    rep_vecs: torch.Tensor
    rep_sq: torch.Tensor
    nn1_stats: torch.Tensor

    @property
    def k_build(self) -> int:
        return self.nbr_ids.shape[1]

    @property
    def cand_per_fetch(self) -> int:
        return self.nbr_ids.shape[1]


def fit_affine_u8(
    base: np.ndarray, clip_quantile: float = 1e-4, levels: int = 255
) -> tuple[np.ndarray, np.ndarray]:
    """Per-dimension affine quantizer fitted on the base (``levels``=255 for
    uint8 codes, 15 for int4).

    The range is clipped at the ``clip_quantile`` tails instead of raw
    min/max: on heavy-tailed data a single outlier dimension would otherwise
    inflate the quantization step for every point (values outside the clipped
    range saturate at 0/levels, which costs only those few points accuracy).
    """
    if clip_quantile > 0.0 and base.shape[0] > 1000:
        lo = np.quantile(base, clip_quantile, axis=0).astype(np.float32)
        hi = np.quantile(base, 1.0 - clip_quantile, axis=0).astype(np.float32)
    else:
        lo = base.min(axis=0).astype(np.float32)
        hi = base.max(axis=0).astype(np.float32)
    scale = np.maximum(hi - lo, 1e-12).astype(np.float32) / float(levels)
    return scale, lo


def match_groups(nbr_ids: np.ndarray, group: int) -> np.ndarray:
    """Group nodes with graph-nearest partners (deterministic, vectorized).

    ``group`` must be a power of two. Pairs come from greedy mutual-nearest
    matching (see :func:`_match_pairs`); larger groups recurse -- pairs are
    re-matched on the induced pair-level adjacency (a pair's neighbor list is
    its members' neighbor *pairs*, interleaved so the graph-nearest-first
    ordering survives), so a group of 4 is two graph-adjacent pairs, etc.
    Returns members [NG, group] i32 (-1 pads only when N % group != 0).
    The grouped index layout that uses it is not ported yet (ROADMAP Queue 1
    item 9).
    """
    N, K = nbr_ids.shape
    if group <= 1:
        return np.arange(N, dtype=np.int32)[:, None]
    if group & (group - 1):
        raise ValueError(f"group={group} must be a power of two")
    pairs = _match_pairs(nbr_ids)
    if group == 2:
        return pairs
    NP = pairs.shape[0]
    # induced pair-level adjacency: map member neighbor ids -> pair ids,
    # interleaved member-major so column order still means nearest-first
    pair_of = np.zeros((N,), np.int64)
    valid = pairs >= 0
    pair_of[pairs[valid]] = np.repeat(
        np.arange(NP, dtype=np.int64), 2
    ).reshape(NP, 2)[valid]
    mem_nbrs = np.where(
        valid[:, :, None], nbr_ids[np.clip(pairs, 0, None)], -1
    )  # [NP, 2, K]
    nbr_pairs = np.where(
        mem_nbrs >= 0, pair_of[np.clip(mem_nbrs, 0, None)], -1
    )
    pair_nbrs = np.transpose(nbr_pairs, (0, 2, 1)).reshape(NP, 2 * K)
    sub = match_groups(pair_nbrs.astype(np.int32), group // 2)
    safe_sub = np.clip(sub, 0, None)
    out = np.where((sub >= 0)[:, :, None], pairs[safe_sub], -1)
    return out.reshape(sub.shape[0], group).astype(np.int32)


def _match_pairs(nbr_ids: np.ndarray) -> np.ndarray:
    """Greedy mutual-nearest pairing in rounds: each unmatched node proposes
    to its nearest unmatched neighbor (neighbor rows are distance-sorted by
    the merge); mutual proposals pair up. Leftovers merge pairwise in id
    order. Returns [ceil(N/2), 2] i32 (-1 pad only for odd N)."""
    N, K = nbr_ids.shape
    partner = np.full((N,), -1, np.int64)
    ids = np.arange(N, dtype=np.int64)
    for _ in range(8):
        free = partner == -1
        if not free.any():
            break
        # nearest *free* neighbor of each free node (first in sorted row)
        nbrs = nbr_ids.astype(np.int64).copy()
        bad = (nbrs < 0) | ~free[np.clip(nbrs, 0, None)] | (nbrs == ids[:, None])
        score = np.where(bad, K, np.arange(K)[None, :])
        best_col = score.argmin(axis=1)
        proposal = np.where(
            score[ids, best_col] < K, nbrs[ids, best_col], -1
        )
        proposal[~free] = -1
        ok = (proposal >= 0) & (proposal[np.clip(proposal, 0, None)] == ids)
        ok &= ids < proposal  # one writer per mutual pair
        a = ids[ok]
        b = proposal[ok]
        partner[a] = b
        partner[b] = a
    # pair the stragglers in id order
    rest = ids[partner == -1]
    if len(rest) >= 2:
        even = rest[: len(rest) // 2 * 2]
        partner[even[0::2]] = even[1::2]
        partner[even[1::2]] = even[0::2]
    is_owner = (partner == -1) | (ids < partner)
    owners = ids[is_owner]  # ascending: deterministic group numbering
    return np.stack([owners, partner[owners]], axis=1).astype(np.int32)


def quantizer_for(base: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero) for a base: identity for uint8 bases (their bytes are
    the codes, the reference's native uint8 mode), else the fitted affine
    map. The quantile fit runs on the host."""
    D = base.shape[1]
    if base.dtype == torch.uint8:
        scale = np.ones((D,), np.float32)
        zero = np.zeros((D,), np.float32)
    else:
        scale, zero = fit_affine_u8(base.cpu().numpy())
    return (torch.from_numpy(scale).to(base.device),
            torch.from_numpy(zero).to(base.device))


def encode_u8(base_f32, scale, zero, levels: int = 255):
    """Codes of the affine quantizer (round half to even, saturating) and
    the exact squared norms of the dequantized points -- the walk's metric."""
    c = torch.round((base_f32 - zero[None, :]) / scale[None, :])
    codes = torch.clamp(c, 0.0, float(levels)).to(torch.uint8)
    x_hat_sq = squared_norms(codes.to(torch.float32) * scale[None, :] + zero[None, :])
    return codes, x_hat_sq


def make_adjacency(codes, x_hat_sq, nbr, scale, zero) -> AdjacencyTables:
    """Inline one layer's adjacency: [N, K, D] neighbour codes (one device
    gather) and the neighbours' dequantized squared norms."""
    safe = nbr.clamp_min(0).long()
    return AdjacencyTables(
        nbr_ids=nbr,
        blocks=codes[safe],
        nbr_sq=torch.where(nbr >= 0, x_hat_sq[safe], EMPTY_DIST),
        scale=scale,
        zero=zero,
    )


def build_fused_index(
    base: torch.Tensor,
    graph: Graph,
    cfg: GraphConfig,
    *,
    group: int = 1,
    bits: int = 8,
    quantizer: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> FusedIndex:
    """Derive the quantized-adjacency index from a built shard graph.
    ``quantizer``: the (scale, zero) already fitted on this base, if any
    (the build fits the same one)."""
    if group != 1:
        raise NotImplementedError(
            "group>1 fused layouts are not ported yet (ROADMAP Queue 1 item 9)"
        )
    if bits != 8:
        raise NotImplementedError(
            "bits=4 indexes are not ported yet (ROADMAP Queue 1 item 9)"
        )
    scale, zero = quantizer if quantizer is not None else (None, None)
    return assemble_fused_index(base, graph, scale=scale, zero=zero)


def assemble_fused_index(
    base: torch.Tensor,
    graph: Graph,
    *,
    scale: torch.Tensor | None = None,
    zero: torch.Tensor | None = None,
) -> FusedIndex:
    """Assemble the device-resident index (one block per node).
    Deterministic given (base, graph[, scale, zero])."""
    if scale is None or zero is None:
        scale, zero = quantizer_for(base)
    base_f32 = base.to(torch.float32)
    codes, x_hat_sq = encode_u8(base_f32, scale, zero)
    adj = make_adjacency(codes, x_hat_sq, graph.neighbors[0], scale, zero)
    rep_ids = graph.translation[1].to(torch.int32)
    rep_vecs = base_f32[rep_ids.long()]
    return FusedIndex(
        nbr_ids=adj.nbr_ids,
        blocks=adj.blocks,
        nbr_sq=adj.nbr_sq,
        scale=scale,
        zero=zero,
        rep_ids=rep_ids,
        rep_vecs=rep_vecs,
        rep_sq=squared_norms(rep_vecs),
        nn1_stats=graph.nn1_stats.to(base.device),
    )


def _code_dists(q_vecs, q_sq, anchors, index, measure):
    """Distances from each row's query to its anchors' inline neighbours.

    anchors: [B, P] i32 (-1 = empty). Returns (ids [B, P*K], d [B, P*K]).
    One contiguous block fetch per anchor: THE hot memory access, run by the
    kernel on the card.
    """
    B, P = anchors.shape
    Kc = index.cand_per_fetch
    safe = anchors.clamp_min(0).long()
    live = (anchors >= 0)[:, :, None]
    ids = torch.where(live, index.nbr_ids[safe], EMPTY_ID).reshape(B, P * Kc)
    sq = torch.where(live, index.nbr_sq[safe], EMPTY_DIST).reshape(B, P * Kc)
    # dot(q, x_hat) = (q * scale) . codes + q . zero
    qs = q_vecs * index.scale[None, :]
    dot = adjacency_dot(qs, anchors, index.blocks).reshape(B, P * Kc)
    dot = dot + (q_vecs @ index.zero)[:, None]
    d = finish(dot, q_sq[:, None], sq, measure)
    bad = (ids == EMPTY_ID) | ~torch.isfinite(sq)
    return ids, torch.where(bad, EMPTY_DIST, d)


def _fused_step(st: BeamState, q_vecs, q_sq, index, measure, *, k_best, P, cap):
    """One pop->fetch->filter->dedup->insert step of the quantized-adjacency
    walk (shared by the query engine and the construction merge).

    Distances are cheap here (computed from the inline codes), so the
    admission criterion filters BEFORE the dedup/merge: keep only the best
    ``cap`` candidates below best+xi, sorted."""
    anchors, active, st = beam_pop(st, P, k_best)
    ids, d = _code_dists(q_vecs, q_sq, anchors, index, measure)
    crit = st.criteria(k_best)
    d = torch.where((ids != EMPTY_ID) & (d < crit[:, None]), d, EMPTY_DIST)
    ids = torch.where(torch.isfinite(d), ids, EMPTY_ID)
    if cap < d.shape[1]:
        d, ids = sort_by_dist(d, ids)
        d, ids = d[:, :cap], ids[:, :cap]
    ok = beam_dedup_mask(st, ids)
    ids = torch.where(ok, ids, EMPTY_ID)
    st = beam_insert(st, ids, d, row_mask=active, criteria=crit)
    return st, active


def _default_cap(P: int, index) -> int:
    # a quarter of the raw tile survives criteria+dedup in steady state;
    # survivors beyond the cap cost at most a revisit
    return max(64, (P * index.cand_per_fetch) // 4)


def fused_best_first(state, q_vecs, q_sq, index, measure, max_iterations: int,
                     k_best: int, pops_per_iter: int = 8, cap: int | None = None):
    """Best-first expansion over inline-code adjacency until convergence or
    the ``max_iterations`` pop budget; returns the final beam."""
    P = max(1, pops_per_iter)
    cap = _default_cap(P, index) if cap is None else cap
    steps = -(-max_iterations // P)
    for _ in range(steps):
        state, active = _fused_step(
            state, q_vecs, q_sq, index, measure, k_best=k_best, P=P, cap=cap
        )
        if not bool(active.any()):
            break
    return state


def fused_best_first_compacted(state, q_vecs, q_sq, index, measure,
                               max_iterations: int, k_best: int,
                               pops_per_iter: int = 8, cap: int | None = None,
                               compact_levels: int = 3):
    """:func:`fused_best_first` with converged-row compaction; returns the
    final ``k_best`` beam columns (ids, dists) per row. Used by the
    construction merge, whose rows run to convergence."""
    P = max(1, pops_per_iter)
    cap = _default_cap(P, index) if cap is None else cap
    return _best_first_phases(
        state, q_vecs, q_sq, index, measure,
        steps=-(-max_iterations // P), k_best=k_best, P=P, cap=cap,
        k_out=k_best, compact_levels=compact_levels, want_d=True,
    )


def _best_first_phases(state, q_vecs, q_sq, index, measure, *, steps: int,
                       k_best: int, P: int, cap: int, k_out: int,
                       compact_levels: int, xi_update=None,
                       want_d: bool = False, min_rows: int = 256):
    """The best-first sweep as PHASES of halving row counts.

    Rows walk independently, so once enough rows of the lock-step tile have
    converged the live rows move into a half-size sub-tile that keeps
    stepping. Every live row still receives its full pop budget, so results
    are identical to the single-phase sweep -- but converged rows stop paying
    the per-step cost (the reference's free per-block exit,
    query_layer.cu:57-79). Each step tests the live count on the host: one
    device sync per step.

    Returns the first ``k_out`` beam columns per original row:
    (ids [B, k_out], dists [B, k_out] or None if not ``want_d``).
    """
    B = q_vecs.shape[0]
    dev = q_vecs.device
    caps = [B]
    for _ in range(max(0, compact_levels)):
        if caps[-1] // 2 >= min_rows:
            caps.append(caps[-1] // 2)

    live = torch.ones((B,), dtype=torch.bool, device=dev)
    it = 0
    st, q, qs = state, q_vecs, q_sq
    idx = torch.arange(B, device=dev)  # original row of each tile row
    out_i = st.i[:, :k_out].clone()
    out_d = st.d[:, :k_out].clone() if want_d else None
    for pi, rows in enumerate(caps):
        next_min = caps[pi + 1] if pi + 1 < len(caps) else 0
        if pi:
            # stable sort brings live rows to the front in original order;
            # the previous phase exited with <= ``rows`` live rows (or out of
            # budget, and then the loop below runs zero steps)
            order = torch.argsort((~live).to(torch.int8), stable=True)
            sel = order[:rows]
            st = st.select(sel)
            q, qs, live, idx = q[sel], qs[sel], live[sel], idx[sel]
        while it < steps and int(live.sum()) > next_min:
            if xi_update is not None:
                st = st._replace(xi=xi_update(st))
            st, live = _fused_step(
                st, q, qs, index, measure, k_best=k_best, P=P, cap=cap
            )
            it += 1
        out_i[idx] = st.i[:, :k_out]
        if want_d:
            out_d[idx] = st.d[:, :k_out]
    return out_i, out_d


@torch.no_grad()
def _fused_query_tile(q_vecs, index: FusedIndex, base, base_sq, tau, *,
                      width: int, vis_size: int, k_query: int,
                      measure: DistanceMeasure, max_iterations: int,
                      pops_per_iter: int, num_seeds: int, rerank: int,
                      cap: int, compact_levels: int):
    B = q_vecs.shape[0]
    P = pops_per_iter
    q_vecs = q_vecs.to(torch.float32)
    q_sq = torch.sum(q_vecs * q_vecs, dim=-1)

    # dynamic slack (query_layer.cu:48-63): from the max 1-NN distance,
    # tightened by the current best distance
    nn1 = index.nn1_stats
    if measure == DistanceMeasure.Euclidean:
        xi0 = (nn1[1] * nn1[1]) * tau * tau

        def dyn(st):
            return torch.minimum(xi0, st.d[:, 0] * tau * tau)
    else:
        xi0 = nn1[1] * tau

        def dyn(st):
            return torch.minimum(xi0, st.d[:, 0] * tau)

    state = beam_init(B, width, xi0, vis_size, device=q_vecs.device)

    # seed: dense rep scan, the best num_seeds enter the beam (exact top-k)
    seed_d_all = dist_block(q_vecs, index.rep_vecs, measure, q_sq=q_sq,
                            c_sq=index.rep_sq)
    seed_d, pos = smallest_k_positions(seed_d_all, num_seeds)
    seed_ids = index.rep_ids[pos]
    no_crit = torch.full((B,), EMPTY_DIST, device=q_vecs.device)
    state = beam_insert(state, seed_ids, seed_d, criteria=no_crit)

    R = min(rerank, width)
    result_i, _ = _best_first_phases(
        state, q_vecs, q_sq, index, measure,
        steps=-(-max_iterations // P), k_best=k_query, P=P, cap=cap,
        k_out=R, compact_levels=compact_levels, xi_update=dyn,
    )

    # exact re-rank of the top survivors (one small f32 gather)
    safe = result_i.clamp_min(0).long()
    vecs = base[safe].to(torch.float32)  # [B, R, D]
    dot = torch.einsum("bd,brd->br", q_vecs, vecs)
    d = finish(dot, q_sq[:, None], base_sq[safe], measure)
    d = torch.where(result_i == EMPTY_ID, EMPTY_DIST, d)
    d, i = sort_by_dist(d, result_i)
    return i[:, :k_query], d[:, :k_query]


def fused_query(
    query: torch.Tensor,
    index: FusedIndex,
    base: torch.Tensor,
    KQuery: int,
    tau_query: float,
    max_iterations: int = 400,
    measure: DistanceMeasure = DistanceMeasure.Euclidean,
    *,
    base_sq: torch.Tensor | None = None,
    chunk: int = 8192,
    pops_per_iter: int = 16,
    num_seeds: int = 16,
    rerank: int | None = None,
    cap: int | None = None,
    vis_size: int | None = None,
    compact_levels: int = 2,
    width: int | None = None,
):
    """Query one shard through its quantized-adjacency index.

    Same user parameters as the reference query (KQuery, tau_query,
    max_iterations -- the total anchor-pop budget, ggnn.cuh:144-155).
    Queries run in tiles of ``chunk`` rows.

    Returns (ids [Q, KQuery] i32, dists [Q, KQuery] f32 exact), rows sorted
    ascending, on the index's device.
    """
    measure = DistanceMeasure(measure)
    width_default, vis_default = GraphConfig.query_beam_geometry(
        KQuery, max_iterations
    )
    if width is None:
        width = width_default
    elif width < KQuery + 1:
        raise ValueError(f"width={width} must exceed KQuery={KQuery}")
    P = max(1, pops_per_iter)
    if vis_size is None:
        # the ring records one id per pop; with capacity >= the total pop
        # budget it never wraps, so sizing it to the budget is exact
        total_pops = -(-max_iterations // P) * P
        vis_size = min(vis_default, max(32, -(-total_pops // 32) * 32))
    if base_sq is None:
        base_sq = squared_norms(base)
    if rerank is None:
        rerank = min(width, max(2 * KQuery, 32))
    if cap is None:
        cap = _default_cap(P, index)
    dev = index.blocks.device
    query = query.to(dev)
    Q = query.shape[0]
    if Q == 0:
        return (torch.zeros((0, KQuery), dtype=torch.int32, device=dev),
                torch.zeros((0, KQuery), dtype=torch.float32, device=dev))
    tau = torch.tensor(tau_query, dtype=torch.float32, device=dev)
    num_seeds = min(num_seeds, int(index.rep_ids.shape[0]))
    outs = [
        _fused_query_tile(
            query[lo : lo + chunk], index, base, base_sq, tau,
            width=width, vis_size=vis_size, k_query=KQuery, measure=measure,
            max_iterations=max_iterations, pops_per_iter=P,
            num_seeds=num_seeds, rerank=rerank, cap=cap,
            compact_levels=max(0, compact_levels),
        )
        for lo in range(0, Q, chunk)
    ]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
