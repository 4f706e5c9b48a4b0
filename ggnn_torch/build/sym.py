"""Inverse ("foreign") link discovery and insertion.

Replacement for the reference's sym pass (``SymQueryKernel``,
src/ggnn/construction/sym_query_layer.cu:39-145, and
``SymBufferMergeKernel``, sym_buffer_merge_layer.cu:36-99). The reference
walks, for each node n and each of its KL local neighbours s, from s back
toward n -- guided by the half-way point ``h = n + (0.5-EPS)(s - n)``
(simple_knn_sym_cache.cuh:159-201) -- checking whether a visited node
already links to n, and otherwise requests an inverse link at the nearest
on-path node with capacity. Here that work is split into phases:

  i.   mutual-link pre-filter (``_rows_needing_walk``): pairs (n, s) whose
       neighbour s already links back need nothing;
  ii.  start-grouped first-expansion filter (``_bulk_filter_grouped``): a
       pair counts as connected when a node the walk would admit on its
       first expansion of s links back to n; the rest propose an inverse
       link down a per-pair preference list of hosts
       (``_bulk_requests``), nearest sources first;
  iii. the residual pairs, whose whole preference list is full: ``bulk``
       drops their link (like the reference's overflow drop after an
       unsuccessful walk), ``hybrid`` walks them (``_sym_walk``).

``mode="walk"`` skips phase ii and walks every pair phase i flags -- the
reference's own shape.

The CUDA ``atomicAdd`` slot reservation (sym_query_layer.cu:124-141) is
replaced by a deterministic sort-based capacity assignment
(``_insert_requests``): every accepted (target, slot) pair gets a unique
rank, so the scatter is deterministic on the card too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ggnn_torch.config import (
    SYM_MAX_PER_PATH_ITERATIONS,
    DistanceMeasure,
    GraphConfig,
)
from ggnn_torch.ops.beam import (
    BeamState,
    beam_dedup_compact,
    beam_init,
    beam_insert,
    beam_pop,
)
from ggnn_torch.ops.distance import finish
from ggnn_torch.utils import graphs

__all__ = ["sym_pass"]

_HALF_EPS = 0.1  # simple_knn_sym_cache.cuh:39
# pairs walked at once inside a request chunk: bounds the walk's scratch
# (the dedup masks and vector gathers grow with it)
_WALK_BATCH = 1 << 15


def _pair_dists(q, h, q_sq, h_sq, cand_vecs, cand_sq, measure):
    """Exact f32 distances of gathered candidates to both the query and the
    half point. q/h: [R, D]; cand_vecs: [R, K, D]; cand_sq: [R, K].
    Returns (dist_q, dist_h), each [R, K]."""
    dq = finish(torch.einsum("rd,rkd->rk", q, cand_vecs), q_sq[:, None],
                cand_sq, measure)
    dh = finish(torch.einsum("rd,rkd->rk", h, cand_vecs), h_sq[:, None],
                cand_sq, measure)
    return dq, dh


class _WalkCarry(NamedTuple):
    """The sym walk's carry: the beam (``BeamState``'s fields) and the rows
    already connected."""

    d: torch.Tensor
    i: torch.Tensor
    exp: torch.Tensor
    vis: torch.Tensor
    vis_head: torch.Tensor
    xi: torch.Tensor
    connected: torch.Tensor  # [R] bool

    @property
    def beam(self) -> BeamState:
        return BeamState(*self[:-1])


def _sym_walk(n, start, nbrs, sym_buffer, translation_l, base, base_sq, xi,
              *, cfg: GraphConfig, measure: DistanceMeasure,
              pops_per_iter: int, route: graphs.Route = graphs.EAGER):
    """Walk from ``start`` toward ``n``; return (connected [R] bool,
    preference list [R, KF]: the KF best on-path nodes).

    Rows are (node, start) pairs (sym_query_layer.cu:87-141). A candidate
    enters the beam only when it is close to both n and the half-way point
    (simple_knn_sym_cache.cuh:423-436); each step pops up to P anchors below
    ``best + xi`` and fetches their KL local links plus their KF requested
    inverse links (``sym_buffer``, read in place: the requests of the
    chunks walked before); a row is connected once a fetched candidate is n
    itself. The first step runs uncapped: the beam holds only the start
    point, so nearly every candidate survives dedup. It and the rest run
    through :func:`graphs.run_steps` (two programs on the graph route), as
    the JAX package's
    ``lax.while_loop`` does: by default (``route``) the per-step loop, one
    live-count read per step, on the card too; ``graphs.GRAPHS`` replays
    CUDA graphs of ``graphs.STEPS_PER_REPLAY`` steps, bit for bit the same.
    The walk is bound by the device, and a step costs the same whatever its
    live rows, so a replay that runs past a slice's last live row loses
    more than the reads it saves: on an H100 a layer-0 pass at 262,144
    points took 5-9% longer on graphs (``sym_bench.py``).
    """
    R = n.shape[0]
    dev = n.device
    KL, KF = cfg.KL, cfg.KF
    KC = KL + KF
    width, vis_size = cfg.sym_beam_geometry()
    P = max(1, pops_per_iter)
    steps = -(-SYM_MAX_PER_PATH_ITERATIONS // P)
    # dedup-before-fetch compaction cap (see ops/traverse.py)
    cap = P * KC if P == 1 else min(P * KC, max(KC, (P * KC // 2 + 7) // 8 * 8))

    def tr(ids):
        ids = ids.long()
        return translation_l[ids].long() if translation_l is not None else ids

    q = base[tr(n)].to(torch.float32)
    s_vec = base[tr(start)].to(torch.float32)
    # half-way point (simple_knn_sym_cache.cuh:159-177)
    h = q + (0.5 - _HALF_EPS) * (s_vec - q)
    q_sq = torch.sum(q * q, dim=-1)
    h_sq = torch.sum(h * h, dim=-1)

    # init_start_point: seed with the start neighbour, fix criteria_half
    dq0, dh0 = _pair_dists(q, h, q_sq, h_sq, s_vec[:, None, :],
                           base_sq[tr(start)][:, None], measure)
    criteria_half = dh0[:, 0] + xi
    state = beam_init(R, width, xi, vis_size, device=dev)
    state = beam_insert(state, start[:, None].to(torch.int32), dq0,
                        criteria=torch.full((R,), float("inf"), device=dev))

    def step(c, k, cap_now=cap):
        q, h, q_sq, h_sq, criteria_half, n = k
        st, connected = c.beam, c.connected
        # criteria_sym = best distance + xi (simple_knn_sym_cache.cuh:285-288)
        crit = st.d[:, 0] + st.xi
        anchors, active, st = beam_pop(st, P, KF, row_mask=~connected,
                                       criteria=crit)  # [R, P]
        safe = anchors.clamp_min(0).long()
        # candidates = KL local links + KF requested inverse links per anchor
        # (sym_query_layer.cu:98-112)
        cand = torch.cat([nbrs[safe, :KL], sym_buffer[safe]], dim=-1)
        cand = cand.reshape(R, P * KC)
        a_ok = (anchors != -1)[:, :, None].expand(R, P, KC).reshape(R, P * KC)
        found = torch.any((cand == n[:, None]) & a_ok, dim=-1) & active
        connected = connected | found
        live = active & ~found
        # dedup on ids BEFORE the vector gather, pack left
        _, packed = beam_dedup_compact(st, cand, a_ok & live[:, None], cap_now)
        cb = tr(packed.clamp_min(0))
        dq, dh = _pair_dists(q, h, q_sq, h_sq, base[cb].to(torch.float32),
                             base_sq[cb], measure)
        # admit only when close to both query and half point
        admitted = torch.where(dh < criteria_half[:, None], packed, -1)
        st = beam_insert(st, admitted, dq, row_mask=live, criteria=crit)
        return _WalkCarry(*st, connected), live

    # degenerate self-link rows (and padding rows) resolve immediately
    carry = _WalkCarry(*state, start == n)
    consts = (q, h, q_sq, h_sq, criteria_half, n)
    live = torch.ones((R,), dtype=torch.bool, device=dev)
    name = ("sym", int(measure), P, KL, KF, cap, translation_l is not None)
    reads = (nbrs, sym_buffer, translation_l, base, base_sq)
    # a chunk's steps make GBs of intermediates: on the graph route the
    # pool takes what the eager warm-up left cached (fresh_pool)
    kw = dict(live_n=R, floor=0, route=graphs.Route(route), reads=reads,
              fresh_pool=True)
    remaining = steps
    if cap < P * KC:
        # a program of its own on the graph route, whose memory comes from
        # the walk's pool rather than lying cached beside it
        carry, *_ = graphs.run_steps(
            lambda c, k: step(c, k, P * KC), carry, consts, live, it=0,
            steps=1, name=name + ("uncapped",), **kw)
        remaining = max(0, steps - 1)
    carry, *_ = graphs.run_steps(step, carry, consts, live, it=0,
                                 steps=remaining, name=name, **kw)
    return carry.connected, carry.beam.best(KF)[0]


def _run_starts(keys: torch.Tensor):
    """For a sorted key vector: (is_new [M] bool, rank of each entry within
    its run of equal keys [M])."""
    M = keys.shape[0]
    pos = torch.arange(M, device=keys.device)
    is_new = torch.ones((M,), dtype=torch.bool, device=keys.device)
    is_new[1:] = keys[1:] != keys[:-1]
    run_start = torch.cummax(torch.where(is_new, pos, 0), dim=0).values
    return is_new, pos - run_start


def _insert_requests(pref, n_req, need, sym_buffer, sym_atomic, *, KF: int):
    """Deterministic capacity-limited scatter replacing the reference's
    atomicAdd loop (sym_query_layer.cu:124-141): each row tries its
    preference hosts in order; per host, requests are ranked in row order,
    and a request is accepted while the host's attempt counter plus its rank
    stays below KF. Updates ``sym_buffer`` / ``sym_atomic`` in place.
    Returns the per-row accept mask."""
    R = pref.shape[0]
    N = sym_atomic.shape[0]
    assigned = ~need
    for j in range(KF):
        tgt = torch.where(~assigned & (pref[:, j] != -1), pref[:, j], N).long()
        # rank requests per target, stable in row order
        order = torch.argsort(tgt, stable=True)
        _, rank_sorted = _run_starts(tgt[order])
        rank = torch.empty_like(rank_sorted)
        rank[order] = rank_sorted
        valid = tgt != N
        fill = torch.where(valid, sym_atomic[tgt.clamp_max(N - 1)], 0)
        pos = fill + rank
        accept = valid & (pos < KF)
        # accepted (tgt, pos) pairs are unique: a deterministic scatter,
        # written through a scratch row N that is never read
        w_tgt = torch.where(accept, tgt, N)
        w_pos = torch.where(accept, pos, 0)
        buf = torch.cat([sym_buffer, sym_buffer[:1]])
        buf[w_tgt, w_pos] = n_req.to(torch.int32)
        sym_buffer.copy_(buf[:N])
        # attempts count even on overflow (reference atomicAdd semantics)
        cnt = torch.zeros((N + 1,), dtype=sym_atomic.dtype, device=tgt.device)
        cnt.index_add_(0, tgt, valid.to(sym_atomic.dtype))
        sym_atomic += cnt[:N]
        assigned = assigned | accept
    return assigned


def _sym_buffer_merge(nbrs, sym_buffer, sym_atomic, *, KL: int, KF: int):
    """Merge requested inverse links into the graph's foreign slots
    (sym_buffer_merge_layer.cu:36-99): keep non-duplicate existing foreign
    links while room remains, pad empties with the node's own id."""
    Nl = nbrs.shape[0]
    node_ids = torch.arange(Nl, dtype=torch.int32, device=nbrs.device)
    out = sym_buffer.clone()
    num = torch.clamp_max(sym_atomic, KF + 1)
    existing = nbrs[:, KL:]
    rows = node_ids.long()
    for i in range(KF):
        g = existing[:, i]
        dup = torch.any(out == g[:, None], dim=-1)
        can = (num < KF) & ~dup
        slot = torch.clamp(num, 0, KF - 1).long()
        cur = out[rows, slot]
        out[rows, slot] = torch.where(can, g, cur)
        num = num + can.to(num.dtype)
    out = torch.where(out >= 0, out, node_ids[:, None])
    new = nbrs.clone()
    new[:, KL:] = out
    return new


def _rows_needing_walk(nbrs, *, KL: int, chunk: int = 65536):
    """Which (node, local-neighbour) pairs are not trivially symmetric.

    A pair is trivially symmetric when the neighbour already links back --
    mutual-kNN pairs, which the reference's walk detects on its very first
    fetch (sym_query_layer.cu:87-97). Row-chunked: the back-link gather is
    [rows, KL, K] and would be tens of GB at 1M unchunked."""
    Nl = nbrs.shape[0]
    outs = []
    for lo in range(0, Nl, chunk):
        starts = nbrs[lo : lo + chunk, :KL]
        back = nbrs[starts.clamp_min(0).long()]  # [C, KL, K]
        node = torch.arange(lo, lo + starts.shape[0], dtype=torch.int32,
                            device=nbrs.device)[:, None]
        direct = torch.any(back == node[:, :, None], dim=-1)
        outs.append((starts != -1) & (starts != node) & ~direct)
    return torch.cat(outs)


def _group_pending_rows(need, nbrs, *, KL: int, R_cap: int):
    """Group pending (node, neighbour) pairs by their START node s, so each
    start's first expansion is gathered once for all its requesters.

    A start with more than R_cap pending requesters spans several
    consecutive group rows, so every pair lands in exactly one grid slot.

    Returns (grid [G, R_cap] flat pair ids (-1 = empty), group_s [G] start
    id per group row (-1 = empty), n_groups) with G an upper bound.
    """
    Nl = nbrs.shape[0]
    M = Nl * KL
    dev = nbrs.device
    pos = torch.arange(M, device=dev)
    s_flat = nbrs[:, :KL].reshape(-1)
    valid = need.reshape(-1) & (s_flat >= 0)
    key = torch.where(valid, s_flat, Nl)  # invalids sort last
    order = torch.argsort(key, stable=True)
    ks = key[order]
    rs = pos[order]
    is_new, rank = _run_starts(ks)
    vs = ks != Nl
    is_start = vs & (is_new | (rank % R_cap == 0))
    gid = torch.cumsum(is_start.to(torch.int64), dim=0) - 1
    n_groups = int(is_start.sum())
    G = Nl + -(-M // R_cap)
    # rows past the real pairs go to a scratch group row G
    tgt = torch.where(vs, gid, G)
    grid = torch.full((G + 1, R_cap), -1, dtype=torch.int64, device=dev)
    grid[tgt, rank % R_cap] = rs
    group_s = torch.full((G + 1,), -1, dtype=torch.int64, device=dev)
    group_s[torch.where(is_start, gid, G)] = ks.to(torch.int64)
    return grid[:G], group_s[:G], n_groups


def _bulk_filter_grouped(group_s, grid_rows, nbrs, translation_l, base,
                         base_sq, xi, *, cfg: GraphConfig,
                         measure: DistanceMeasure):
    """Start-grouped first-expansion connectivity filter.

    For all of a start s's requesters n against ONE gather of s's
    expansion: a first-expansion candidate t of s is admitted when it is
    close to both n and the half-way point h = n + (0.5-EPS)(s - n)
    (simple_knn_sym_cache.cuh:159-177, 423-436); the pair is connected when
    an admitted t links back to n (sym_query_layer.cu:87-122). The preference
    list is s plus the admitted candidates, nearest to n first.

    Returns (connected, dq0, n, pref) over the [C, R] pair grid.
    """
    KL, KF = cfg.KL, cfg.KF
    C, R = grid_rows.shape
    pad = (grid_rows == -1) | (group_s[:, None] == -1)
    n = grid_rows.clamp_min(0) // KL  # [C, R] requesters
    s = torch.where(group_s == -1, 0, group_s)  # [C]

    def tr(ids):
        return translation_l[ids].long() if translation_l is not None else ids

    s_vec = base[tr(s)].to(torch.float32)  # [C, D]
    s_sq = base_sq[tr(s)]  # [C]
    q = base[tr(n)].to(torch.float32)  # [C, R, D]
    q_sq = torch.sum(q * q, dim=-1)  # [C, R]
    h = q + (0.5 - _HALF_EPS) * (s_vec[:, None, :] - q)
    h_sq = torch.sum(h * h, dim=-1)

    # shared expansion of s: one gather per GROUP, not per pair
    t = nbrs[s, :KL]  # [C, KL]
    t_safe = t.clamp_min(0).long()
    t_vecs = base[tr(t_safe)].to(torch.float32)  # [C, KL, D]
    t_sq = base_sq[tr(t_safe)]  # [C, KL]
    back = nbrs[t_safe, :KL]  # [C, KL, KL]: each t's local links

    dq0 = finish(torch.einsum("crd,cd->cr", q, s_vec), q_sq, s_sq[:, None], measure)
    dh0 = finish(torch.einsum("crd,cd->cr", h, s_vec), h_sq, s_sq[:, None], measure)
    crit_q = dq0 + xi
    crit_h = dh0 + xi
    dq_t = finish(torch.einsum("crd,ckd->crk", q, t_vecs), q_sq[..., None],
                  t_sq[:, None, :], measure)
    dh_t = finish(torch.einsum("crd,ckd->crk", h, t_vecs), h_sq[..., None],
                  t_sq[:, None, :], measure)
    t_ok = (t[:, None, :] != -1) & (t[:, None, :] != n[:, :, None])  # [C, R, KL]
    admitted = t_ok & (dh_t < crit_h[..., None]) & (dq_t < crit_q[..., None])
    links_back = torch.any(back[:, None, :, :] == n[:, :, None, None], dim=-1)
    connected = torch.any(links_back & admitted, dim=-1) | pad

    cand = torch.cat(
        [s[:, None, None].expand(C, R, 1), t[:, None, :].expand(C, R, KL).long()],
        dim=-1,
    )  # [C, R, 1+KL]
    cand_d = torch.cat([dq0[..., None], dq_t], dim=-1)
    cand_ok = torch.cat([~pad[..., None], admitted], dim=-1)
    cand_d = torch.where(cand_ok, cand_d, float("inf"))
    cand = torch.where(cand_ok, cand, -1)
    _, o = torch.sort(cand_d, dim=-1, stable=True)
    pref = torch.gather(cand, -1, o[..., :KF]).to(torch.int32)
    n_out = torch.where(pad, -1, n).to(torch.int32)
    return connected, torch.where(pad, float("inf"), dq0), n_out, pref


def _bulk_requests(pref, src, prio, sym_buffer, sym_atomic, connected, *,
                   KF: int):
    """Bulk inverse-link proposals down per-row preference lists.

    Live requests (not ``connected``) are processed in ascending-priority
    order (nearest sources claim slots first -- the deterministic
    replacement for the reference's first-come atomicAdd race); each tries
    its preference hosts in order until one has capacity. The need flag is
    the leading sort key, so a live request always precedes the rest
    whatever its priority. Returns the per-row accept mask."""
    M = pref.shape[0]
    need = ~connected
    order = torch.argsort(prio, stable=True)
    order = order[torch.argsort((~need[order]).to(torch.int8), stable=True)]
    cnt = int(need.sum())
    accept = torch.zeros((M,), dtype=torch.bool, device=pref.device)
    if cnt == 0:
        return accept
    sel = order[:cnt]
    acc = _insert_requests(
        pref[sel], src[sel], torch.ones((cnt,), dtype=torch.bool,
                                        device=pref.device),
        sym_buffer, sym_atomic, KF=KF,
    )
    accept[sel] = acc
    return accept


def _phase_ii_grouped(need, nbrs, trans, base, base_sq, xi, sym_buffer,
                      sym_atomic, *, cfg: GraphConfig, measure,
                      want_residual_rows: bool = False):
    """Phase ii: group the pending pairs by start, filter them in chunks of
    ``Cs`` groups x ``R_cap`` requesters, then one bulk request round.
    Returns (the phase's counters, residual pair ids [M] in grid order --
    empty unless ``want_residual_rows``)."""
    KL, KF = cfg.KL, cfg.KF
    R_cap = 16
    Cs = 4096
    grid, group_s, ng = _group_pending_rows(need, nbrs, KL=KL, R_cap=R_cap)
    stats = {"bulk_connected": 0, "bulk_accepted": 0, "residual": 0}
    rows = torch.zeros((0,), dtype=torch.int64, device=nbrs.device)
    if ng == 0:
        return stats, rows
    conn_parts, dq0_parts, n_parts, pref_parts = [], [], [], []
    for lo in range(0, ng, Cs):
        hi = min(lo + Cs, ng)
        conn, dq0, n_ids, pref = _bulk_filter_grouped(
            group_s[lo:hi], grid[lo:hi], nbrs, trans, base, base_sq, xi,
            cfg=cfg, measure=measure,
        )
        conn_parts.append(conn.reshape(-1))
        dq0_parts.append(dq0.reshape(-1))
        n_parts.append(n_ids.reshape(-1))
        pref_parts.append(pref.reshape(-1, KF))
    connected = torch.cat(conn_parts)
    n_flat = torch.cat(n_parts)
    dq0_all = torch.cat(dq0_parts)
    pref_all = torch.cat(pref_parts)
    del conn_parts, dq0_parts, n_parts, pref_parts
    accept = _bulk_requests(pref_all, n_flat, dq0_all, sym_buffer, sym_atomic,
                            connected, KF=KF)
    del pref_all
    real = n_flat != -1
    resid = real & ~connected & ~accept
    stats["bulk_connected"] = int((real & connected).sum())
    stats["bulk_accepted"] = int((real & accept).sum())
    stats["residual"] = int(resid.sum())
    if want_residual_rows and stats["residual"]:
        rows = grid[:ng].reshape(-1)[resid]
    return stats, rows


def _walk_chunk_rows(n_rows: int, Nl: int, KL: int, chunk_nodes: int) -> int:
    """Pairs per walk chunk of a pass that walks ``n_rows`` pairs of a
    layer of ``Nl`` nodes: ``chunk_nodes * KL``, and no more than the power
    of two of at least 4096 that holds the pairs (the JAX package's ladder
    for hybrid mode), so that a small residual or a small layer walks a
    small shape; the ladder never moves a chunk's bounds."""
    ladder = max(4096, 1 << (n_rows - 1).bit_length())
    return min(chunk_nodes * KL, Nl * KL, ladder)


def _walk_requests(rows, nbrs, trans, base, base_sq, xi, sym_buffer,
                   sym_atomic, *, cfg: GraphConfig, measure, chunk_rows: int,
                   pops_per_iter: int, route: graphs.Route = graphs.EAGER):
    """Phase iii: walk the given (node, neighbour) pairs and request inverse
    links for the unconnected ones.

    Chunks of ``chunk_rows`` pairs run in order, each walking against the
    request state its predecessors left, so later chunks see earlier
    chunks' requests (the reference gets the same effect through
    global-memory atomics; the JAX package carries it through the scan of
    ``_sym_scan_block``). Inside a chunk the walks are independent; they run
    in equal slices of at most ``_WALK_BATCH`` pairs, the last chunk padded
    with empty rows to whole slices (as the JAX package pads its row chunks
    with -1), so that every slice of a pass has one shape; the chunk's
    requests are then inserted in pair order. An empty row walks from its
    own node: it is connected at once and requests nothing. Updates
    ``sym_buffer`` / ``sym_atomic`` in place."""
    KL = cfg.KL
    n_slices = -(-chunk_rows // _WALK_BATCH)
    batch = -(-chunk_rows // n_slices)
    for lo in range(0, rows.shape[0], chunk_rows):
        r = rows[lo : lo + chunk_rows]
        r = torch.cat([r, r.new_full((-r.shape[0] % batch,), -1)])
        n = r.clamp_min(0) // KL
        start = nbrs[n, r.clamp_min(0) % KL].long()
        pad = (r == -1) | (start == -1)
        start = torch.where(pad, n, start)
        parts = [
            _sym_walk(n[b : b + batch], start[b : b + batch], nbrs, sym_buffer,
                      trans, base, base_sq, xi, cfg=cfg, measure=measure,
                      pops_per_iter=pops_per_iter, route=route)
            for b in range(0, r.shape[0], batch)
        ]
        connected = torch.cat([c for c, _ in parts])
        pref = torch.cat([p for _, p in parts])
        _insert_requests(pref, n, ~connected & ~pad, sym_buffer, sym_atomic,
                         KF=cfg.KF)


@torch.no_grad()
def sym_pass(
    base: torch.Tensor,
    base_sq: torch.Tensor,
    nbrs: torch.Tensor,
    translation_l: torch.Tensor | None,
    nn1_stats: torch.Tensor,
    cfg: GraphConfig,
    layer: int,
    measure: DistanceMeasure,
    tau_build: float,
    chunk_nodes: int = 4096,
    pops_per_iter: int = 4,
    mode: str = "bulk",
    *,
    route: graphs.Route = graphs.EAGER,
):
    """Run the sym pass on one layer.

    ``mode``: "bulk" (phases i-ii, residual links dropped; the default),
    "hybrid" (phases i-iii: the residual pairs are walked) or "walk" (phase
    i, then every flagged pair is walked). Walks run in chunks of
    :func:`_walk_chunk_rows` pairs (see :func:`_walk_requests`). ``route``:
    how the walks' steps run (:func:`_sym_walk`; the per-step loop unless
    ``graphs.GRAPHS`` is asked for).

    Returns (new_nbrs, stats dict with overflow/added-links counters matching
    graph_construction.cu:354-378, and the walk's live-count reads and the
    CUDA graphs it captured on this thread: ``walk_live_reads``,
    ``walk_graphs_captured``).
    """
    if mode not in ("bulk", "hybrid", "walk"):
        raise ValueError(f"unknown sym mode {mode!r}")
    measure = DistanceMeasure(measure)
    dev = base.device
    Nl = cfg.Ns[layer]
    KL, KF = cfg.KL, cfg.KF
    trans = translation_l if layer > 0 else None
    tau = torch.tensor(tau_build, dtype=torch.float32, device=dev)
    if measure == DistanceMeasure.Euclidean:
        xi = (nn1_stats[0] * nn1_stats[0]) * tau * tau
    else:
        xi = nn1_stats[0] * tau

    need = _rows_needing_walk(nbrs, KL=KL)
    sym_buffer = torch.full((Nl, KF), -1, dtype=torch.int32, device=dev)
    sym_atomic = torch.zeros((Nl,), dtype=torch.int32, device=dev)
    stats_ii = {"bulk_connected": 0, "bulk_accepted": 0, "residual": 0}
    if mode == "walk":
        rows = torch.nonzero(need.reshape(-1))[:, 0]
    else:
        stats_ii, rows = _phase_ii_grouped(
            need, nbrs, trans, base, base_sq, xi, sym_buffer, sym_atomic,
            cfg=cfg, measure=measure, want_residual_rows=mode == "hybrid",
        )
    reads, captures = graphs.thread_live_reads(), graphs.thread_captures()
    try:
        if rows.shape[0]:
            _walk_requests(rows, nbrs, trans, base, base_sq, xi, sym_buffer,
                           sym_atomic, cfg=cfg, measure=measure,
                           chunk_rows=_walk_chunk_rows(rows.shape[0], Nl, KL,
                                                      chunk_nodes),
                           pops_per_iter=pops_per_iter, route=route)
    finally:
        # the walks' programs read this pass's graph and request buffer by
        # address; the pass returns a new graph
        graphs.drop(nbrs, sym_buffer)
    new_nbrs = _sym_buffer_merge(nbrs, sym_buffer, sym_atomic, KL=KL, KF=KF)
    stats = {
        "overflow": int((sym_atomic > KF).sum()),
        "added_links": int(torch.clamp_max(sym_atomic, KF).sum()),
        "N": Nl,
        "walk_rows": int(rows.shape[0]),
        "dropped_rows": stats_ii["residual"] if mode == "bulk" else 0,
        "bulk_connected": stats_ii["bulk_connected"],
        "bulk_accepted": stats_ii["bulk_accepted"],
        "total_rows": int(Nl * KL),
        "walk_live_reads": graphs.thread_live_reads() - reads,
        "walk_graphs_captured": graphs.thread_captures() - captures,
    }
    return new_nbrs, stats
