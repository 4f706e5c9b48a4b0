"""Inverse ("foreign") link discovery and insertion -- ``mode="bulk"``.

Replacement for the reference's sym pass (``SymQueryKernel``,
src/ggnn/construction/sym_query_layer.cu:39-145, and
``SymBufferMergeKernel``, sym_buffer_merge_layer.cu:36-99), decomposed into
phases that need no per-pair walk:

  i.   mutual-link pre-filter (``_rows_needing_walk``): pairs (n, s) whose
       neighbour s already links back need nothing;
  ii.  start-grouped first-expansion filter (``_bulk_filter_grouped``): a
       pair counts as connected when a node the walk would admit on its
       first expansion of s links back to n; the rest propose an inverse
       link down a per-pair preference list of hosts
       (``_bulk_requests``), nearest sources first;
  iii. pairs whose whole preference list is full drop their link, like the
       reference's overflow drop after an unsuccessful walk.

The CUDA ``atomicAdd`` slot reservation (sym_query_layer.cu:124-141) is
replaced by a deterministic sort-based capacity assignment
(``_insert_requests``): every accepted (target, slot) pair gets a unique
rank, so the scatter is deterministic on the card too.

The residual walks of the ``hybrid`` and ``walk`` modes are not ported yet
(ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import torch

from ggnn_torch.config import DistanceMeasure, GraphConfig
from ggnn_torch.ops.distance import finish

__all__ = ["sym_pass"]

_HALF_EPS = 0.1  # simple_knn_sym_cache.cuh:39


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
                      sym_atomic, *, cfg: GraphConfig, measure):
    """Phase ii: group the pending pairs by start, filter them in chunks of
    ``Cs`` groups x ``R_cap`` requesters, then one bulk request round.
    Returns the phase's counters."""
    KL, KF = cfg.KL, cfg.KF
    R_cap = 16
    Cs = 4096
    grid, group_s, ng = _group_pending_rows(need, nbrs, KL=KL, R_cap=R_cap)
    stats = {"bulk_connected": 0, "bulk_accepted": 0, "residual": 0}
    if ng == 0:
        return stats
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
    stats["bulk_connected"] = int((real & connected).sum())
    stats["bulk_accepted"] = int((real & accept).sum())
    stats["residual"] = int((real & ~connected & ~accept).sum())
    return stats


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
):
    """Run the sym pass on one layer in ``bulk`` mode (the default of the
    JAX package).

    Returns (new_nbrs, stats dict with overflow/added-links counters matching
    graph_construction.cu:354-378).
    """
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
    stats_ii = _phase_ii_grouped(
        need, nbrs, trans, base, base_sq, xi, sym_buffer, sym_atomic,
        cfg=cfg, measure=measure,
    )
    new_nbrs = _sym_buffer_merge(nbrs, sym_buffer, sym_atomic, KL=KL, KF=KF)
    stats = {
        "overflow": int((sym_atomic > KF).sum()),
        "added_links": int(torch.clamp_max(sym_atomic, KF).sum()),
        "N": Nl,
        "walk_rows": 0,
        "dropped_rows": stats_ii["residual"],
        "bulk_connected": stats_ii["bulk_connected"],
        "bulk_accepted": stats_ii["bulk_accepted"],
        "total_rows": int(Nl * KL),
    }
    return new_nbrs, stats
