"""Batched best-first graph traversal state (the "SimpleKNNCache").

The reference keeps per-query traversal state in CUDA shared memory: a sorted
best list ``[0, BEST)``, a sorted priority-queue ring ``[BEST, SORTED)`` and a
visited ring ``[SORTED, CACHE)`` (include/ggnn/cuda_utils/
simple_knn_cache.cuh:41-87). One block serves one query.

Here a whole batch of rows walks in lock step, and the state is ONE sorted
tensor per row with an "expanded" flag -- the *flagged beam* -- plus an
id-only visited ring:

  * ``d/i [B, W]``   -- the W best candidates ever admitted, sorted ascending
                        (W = the reference's SORTED size, best+queue).
  * ``exp [B, W]``   -- True once a slot's node has been expanded: the
                        reference's best-list/queue split collapses into this
                        flag ("queue" = unexpanded entries, results = the
                        leading ``k_best`` entries).
  * ``vis [B, V]``   -- ring of expanded ids (dedup history). An expanded
                        entry pushed past column W would otherwise be
                        re-added and re-expanded through a back-edge; the
                        reference's visited ring exists for exactly this, and
                        dropping it measurably hurts recall and speed.
  * ``xi [B]``       -- slack for the stopping criterion.

``beam_pop`` selects the first P unexpanded entries below
``d[K_best-1] + xi`` (the reference's ``best.worst() + xi``), flags them and
records them in the ring; ``beam_insert`` is one sorted merge. Rows converge
independently via masks; the caller's loop ends when every row's pop comes up
empty (the batched equivalent of the reference's per-block ``break``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ggnn_torch.config import DistanceMeasure

__all__ = [
    "BeamState",
    "Slack",
    "beam_init",
    "beam_dedup_mask",
    "beam_compact_candidates",
    "beam_insert",
    "beam_pop",
    "beam_transform",
]

EMPTY_ID = -1
EMPTY_DIST = float("inf")


class BeamState(NamedTuple):
    d: torch.Tensor  # [B, W] f32, sorted ascending, inf = empty
    i: torch.Tensor  # [B, W] i32, -1 = empty
    exp: torch.Tensor  # [B, W] bool, True = already expanded
    vis: torch.Tensor  # [B, V] i32 ring of expanded ids (-1 = empty)
    vis_head: torch.Tensor  # [B] i32 next ring slot
    xi: torch.Tensor  # [B] f32

    @property
    def batch(self) -> int:
        return self.d.shape[0]

    @property
    def width(self) -> int:
        return self.d.shape[1]

    def best(self, k: int):
        """The current k best (ids, dists), sorted ascending."""
        return self.i[:, :k], self.d[:, :k]

    def criteria(self, k_best: int) -> torch.Tensor:
        """``best.worst() + xi`` (simple_knn_cache.cuh:121-124). While fewer
        than ``k_best`` entries exist the k-th distance is inf, so everything
        is admitted -- matching the reference's EMPTY_DIST-initialized best
        list."""
        return self.d[:, k_best - 1] + self.xi

    def select(self, rows: torch.Tensor) -> "BeamState":
        """The sub-beam of the given rows."""
        return BeamState(*(t[rows] for t in self))


class Slack(NamedTuple):
    """The query walk's dynamic slack (query_layer.cu:48-63): ``xi0`` from
    the max 1-NN distance, tightened before each pop by the current best
    distance -- ``min(xi0, d[0] * tau^2)`` for squared Euclidean distances,
    ``min(xi0, d[0] * tau)`` for cosine. Called on a beam it gives the new
    ``xi``. Its tensors are data, not a closure, so that a captured walk
    reads them from its own buffers."""

    xi0: torch.Tensor  # [] f32
    tau: torch.Tensor  # [] f32
    measure: DistanceMeasure

    def __call__(self, state: "BeamState") -> torch.Tensor:
        if self.measure == DistanceMeasure.Euclidean:
            return torch.minimum(self.xi0, state.d[:, 0] * self.tau * self.tau)
        return torch.minimum(self.xi0, state.d[:, 0] * self.tau)


def beam_init(
    batch: int, width: int, xi, vis_size: int = 0, device="cpu"
) -> BeamState:
    """Empty beam of the given width and visited-ring size; ``xi``: [B] or
    scalar slack."""
    xi = torch.as_tensor(xi, dtype=torch.float32, device=device)
    return BeamState(
        d=torch.full((batch, width), EMPTY_DIST, device=device),
        i=torch.full((batch, width), EMPTY_ID, dtype=torch.int32, device=device),
        exp=torch.zeros((batch, width), dtype=torch.bool, device=device),
        vis=torch.full(
            (batch, max(vis_size, 1)), EMPTY_ID, dtype=torch.int32, device=device
        ),
        vis_head=torch.zeros((batch,), dtype=torch.int32, device=device),
        xi=xi.expand(batch).clone(),
    )


def beam_dedup_mask(
    state: BeamState,
    cand_i: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Which candidates are new to the beam (the id-only part of ``fetch``).

    Mirrors simple_knn_cache.cuh:126-146 & 241-261: drop a candidate already
    present in the beam or the visited ring, or earlier in this same tile.
    Returns a [B, K] bool mask.
    """
    K = cand_i.shape[1]
    ok = cand_i != EMPTY_ID
    if valid is not None:
        ok &= valid
    # dedup within the tile: keep the first occurrence only
    eq = cand_i[:, :, None] == cand_i[:, None, :]  # [B, K, K]
    lower = torch.ones((K, K), dtype=torch.bool, device=cand_i.device).tril(-1)
    ok &= ~torch.any(eq & lower, dim=-1)
    # dedup against the beam and the visited ring
    seen = torch.cat([state.i, state.vis], dim=-1)
    ok &= ~torch.any(cand_i[:, :, None] == seen[:, None, :], dim=-1)
    return ok


def beam_compact_candidates(cand_i: torch.Tensor, ok: torch.Tensor, cap: int):
    """Pack the surviving candidates left and truncate to ``cap`` columns.

    Graph walks re-encounter most neighbour ids, so after dedup typically
    less than half a tile survives; compacting before the vector gather
    shrinks the gather. Order among survivors is preserved (a stable sort on
    the drop flag). Returns [B, min(cap, K)] ids with EMPTY padding.
    """
    K = cand_i.shape[1]
    cap = min(cap, K)
    _, order = torch.sort((~ok).to(torch.int8), dim=-1, stable=True)
    packed = torch.gather(cand_i, -1, order[:, :cap])
    col = torch.arange(cap, device=cand_i.device)[None, :]
    return torch.where(col < ok.sum(dim=-1, keepdim=True), packed, EMPTY_ID)


def beam_insert(
    state: BeamState,
    cand_i: torch.Tensor,
    cand_d: torch.Tensor,
    row_mask: torch.Tensor | None = None,
    *,
    criteria: torch.Tensor,
) -> BeamState:
    """Merge deduplicated candidates into the beam (one sorted merge).

    The admission criterion (fetch at simple_knn_cache.cuh:284) is applied
    here; ids must already be unique vs the beam and within the tile (see
    :func:`beam_dedup_mask`). EMPTY ids are ignored. Entries pushed past
    column W fall off -- exactly the reference's finite sorted cache.
    """
    ok = (cand_i != EMPTY_ID) & (cand_d < criteria[:, None])
    cand_d = torch.where(ok, cand_d, EMPTY_DIST)
    cand_i = torch.where(ok, cand_i, EMPTY_ID)
    # (id, exp) travel as one payload 2*id + exp; EMPTY -1 packs to -2 (or
    # -1 when flagged) and the arithmetic shift below maps both back to -1.
    # Requires id < 2^30.
    ip_state = state.i * 2 + state.exp.to(torch.int32)
    ip_cand = cand_i * 2  # fresh candidates are never expanded
    d = torch.cat([state.d, cand_d], dim=-1)
    ip = torch.cat([ip_state, ip_cand], dim=-1)
    d, order = torch.sort(d, dim=-1, stable=True)
    W = state.width
    d = d[:, :W]
    ip = torch.gather(ip, -1, order[:, :W])
    i = ip >> 1
    exp = (ip & 1) == 1
    if row_mask is not None:
        m = row_mask[:, None]
        d = torch.where(m, d, state.d)
        i = torch.where(m, i, state.i)
        exp = torch.where(m, exp, state.exp)
    return state._replace(d=d, i=i, exp=exp)


def beam_pop(
    state: BeamState,
    P: int,
    k_best: int,
    row_mask: torch.Tensor | None = None,
    *,
    criteria: torch.Tensor | None = None,
):
    """Select and flag the first P unexpanded entries passing the criterion.

    The batched widening of the reference pop (simple_knn_cache.cuh:215-239):
    the beam is sorted, so the P best unexpanded entries below
    ``d[k_best-1] + xi`` (or the given per-row ``criteria``) are this step's
    anchors. P=1 reproduces the reference's one-anchor-at-a-time visit order.

    A popped entry beyond the ``k_best`` result prefix is BLANKED (the
    reference removes the popped queue copy, simple_knn_cache.cuh:233-235;
    its id lives on in the visited ring for dedup). A popped entry inside the
    prefix stays -- it is the reference's best-list copy. The blanked tail is
    re-sorted by the next insert.

    Returns: (anchors [B, P] i32 with EMPTY padding, active [B] bool,
    new_state).
    """
    B, W = state.d.shape
    dev = state.d.device
    crit = state.criteria(k_best) if criteria is None else criteria
    mask = ~state.exp & (state.i != EMPTY_ID) & (state.d < crit[:, None])
    if row_mask is not None:
        mask &= row_mask[:, None]
    # first-P selection via prefix-sum ranks (the beam is already ordered,
    # so the first P eligible columns ARE the P best)
    iota = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    rank = torch.cumsum(mask.to(torch.int32), dim=-1, dtype=torch.int32)
    hit = mask & (rank <= P)  # [B, W] the popped positions
    oh = hit[:, :, None] & (
        rank[:, :, None]
        == torch.arange(1, P + 1, dtype=torch.int32, device=dev)[None, None, :]
    )  # [B, W, P] one-hot by pop order
    anchors = (
        torch.sum((state.i + 1)[:, :, None] * oh.to(torch.int32), dim=1) - 1
    ).to(torch.int32)
    valid = anchors != EMPTY_ID

    evict = hit & (iota >= k_best)
    d = torch.where(evict, EMPTY_DIST, state.d)
    i = torch.where(evict, EMPTY_ID, state.i)
    exp = state.exp | hit

    # record popped ids in the visited ring (the reference appends on pop,
    # simple_knn_cache.cuh:230-236)
    V = state.vis.shape[-1]
    cnt = torch.sum(valid, dim=-1, dtype=torch.int32)
    slot = (
        state.vis_head[:, None]
        + torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    ) % V
    # empty pops write to a scratch column V that is cut off again (a
    # boolean-mask write would cost a device->host sync for its size)
    w_slot = torch.where(valid, slot, V).long()
    vis = torch.cat([state.vis, state.vis[:, :1]], dim=-1)
    vis = vis.scatter(1, w_slot, anchors)[:, :V]
    vis_head = (state.vis_head + cnt) % V

    return anchors, torch.any(valid, dim=-1), state._replace(
        d=d, i=i, exp=exp, vis=vis, vis_head=vis_head
    )


def beam_transform(state: BeamState, mapping: torch.Tensor,
                   keep: int) -> BeamState:
    """Descend one layer: remap the best ``keep`` ids, reset expansion flags.

    Mirrors simple_knn_cache.cuh:297-333: best-list ids are remapped through
    ``mapping`` (selection: layer-l id -> layer-(l-1) id), everything becomes
    expandable again (the reference re-seeds its queue from the best list and
    clears the visited ring), entries beyond ``keep`` are dropped.
    """
    col = torch.arange(state.width, device=state.d.device)[None, :]
    ok = (state.i != EMPTY_ID) & (col < keep)
    safe = state.i.clamp(0, mapping.shape[0] - 1).long()
    return state._replace(
        i=torch.where(ok, mapping[safe].to(torch.int32), EMPTY_ID),
        d=torch.where(ok, state.d, EMPTY_DIST),
        exp=torch.zeros_like(state.exp),
        vis=torch.full_like(state.vis, EMPTY_ID),
        vis_head=torch.zeros_like(state.vis_head),
    )
