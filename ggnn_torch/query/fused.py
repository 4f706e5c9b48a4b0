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
    (query_kernels.cu:149 seeds from translation[L-1]); with
    ``seed_approx`` the seeds are the TPU's approximate top-k, one launch of
    the kernel in ``ops/approx_topk.py`` after the product;
  * the best-first walk is the flagged-beam traversal (pop -> expand ->
    filter -> dedup -> insert under ``best + xi``), with the reference's
    dynamic slack tightening (query_layer.cu:58-63); on the card its steps
    replay as CUDA graphs, the host reading the live-row count once per
    replay (``utils/graphs.py``, the JAX package's ``jax.jit`` +
    ``lax.while_loop``);
  * a final exact re-rank gathers f32 rows for only the surviving top
    candidates.

Distances during the walk are exact distances to the *dequantized* points,
so the walk explores the true graph with a slightly perturbed metric, and
the re-rank restores exact ordering.

Blocks are stored per *group* of graph-close nodes (``group=2`` pairs
mutual-nearest neighbours): one fetch serves every member, and anchors of
one pop tile that share a group collapse to one fetch. ``bits=4`` packs two
neighbours' int4 codes per byte. The walk's neighbour ids and dequantized
squared norms are two plain tensors beside the code blocks, in the blocks'
fetch-column order. What cannot be re-derived from (base, graph) -- the
group matching and the quantizer -- persists as a ``.fused.npz`` sidecar in
the JAX package's ``meta-v2`` format (:class:`FusedIndexMeta`).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ggnn_torch.config import DistanceMeasure, GraphConfig
from ggnn_torch.graph import Graph
from ggnn_torch.ops.adjacency import adjacency_dot, count_fetched
from ggnn_torch.ops.adjacency import variant as adjacency_variant
from ggnn_torch.ops.approx_topk import dist_approx_smallest_k
from ggnn_torch.ops.beam import (
    BeamState,
    Slack,
    beam_dedup_mask,
    beam_init,
    beam_insert,
    beam_pop,
    cap_candidates,
)
from ggnn_torch.ops.distance import dist_block, finish, squared_norms
from ggnn_torch.ops.gather_dist import gather_dist
from ggnn_torch.ops.topk import smallest_k_positions, sort_by_dist
from ggnn_torch.utils import graphs
from ggnn_torch.utils.spans import recording, span

__all__ = [
    "AdjacencyTables",
    "FusedIndex",
    "FusedIndexMeta",
    "assemble_fused_index",
    "build_fused_index",
    "encode_u8",
    "fit_affine_u8",
    "fused_best_first",
    "fused_best_first_compacted",
    "fused_index_matches_graph",
    "fused_query",
    "graph_fingerprint",
    "load_fused_index",
    "make_adjacency",
    "match_groups",
    "meta_of",
    "pad_rows",
    "save_fused_index",
    "tile_plan",
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
      nbr_ids: [NG, G*K] i32 -- the group members' neighbour ids, member-
        major (-1 = empty slot), in the blocks' fetch-column order: with
        int4 codes the even columns, then the odd ones.
      blocks: [NG, CR, D] u8 -- the fetch unit: the members' neighbours'
        quantized vectors inline (CR = G*K, or G*K/2 with two int4 codes
        per byte, the even neighbour in the low nibble).
      nbr_sq: [NG, G*K] f32 -- squared norms of the dequantized neighbours,
        in ``nbr_ids``' order.
      group_of: [N] i32 -- node id -> its group (the fetch address).
      members: [NG, G] i32 -- group -> member node ids (-1 pad).
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
    group_of: torch.Tensor
    members: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    rep_ids: torch.Tensor
    rep_vecs: torch.Tensor
    rep_sq: torch.Tensor
    nn1_stats: torch.Tensor

    @property
    def k_build(self) -> int:
        """Neighbour ids per group member."""
        return self.nbr_ids.shape[1] // self.group

    @property
    def group(self) -> int:
        return self.members.shape[1]

    @property
    def cand_per_fetch(self) -> int:
        """Candidate ids delivered by one block fetch."""
        return self.nbr_ids.shape[1]

    @property
    def bits(self) -> int:
        """Code width (8 = one neighbour per block row, 4 = two packed)."""
        return 8 if self.blocks.shape[1] == self.nbr_ids.shape[1] else 4


class FusedIndexMeta(NamedTuple):
    """Host-persisted form of a :class:`FusedIndex`: only what cannot be
    re-derived from (base, graph) -- the group matching and the quantizer.
    The inline-code tables are re-assembled by one device gather at
    stage-in (:func:`assemble_fused_index`).

    ``graph_fp`` fingerprints the layer-0 adjacency the matching came from;
    a sidecar whose fingerprint does not match the loaded graph is rejected.
    All zeros means "unvalidatable" and is rejected as well."""

    members: np.ndarray  # [NG, G] i32
    scale: np.ndarray  # [D] f32
    zero: np.ndarray  # [D] f32
    graph_fp: np.ndarray  # [32] u8 blake2b of neighbors[0]
    bits: np.ndarray  # [1] i32 code width (8 = uint8, 4 = packed int4)


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


def quantizer_for(base: torch.Tensor, levels: int = 255
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero) for a base: identity for uint8 bases at 255 levels
    (their bytes are the codes, the reference's native uint8 mode), else
    the fitted affine map (``levels`` 15 for int4). The quantile fit runs
    on the host."""
    D = base.shape[1]
    if base.dtype == torch.uint8 and levels == 255:
        scale = np.ones((D,), np.float32)
        zero = np.zeros((D,), np.float32)
    else:
        scale, zero = fit_affine_u8(base.cpu().numpy(), levels=levels)
    return (torch.from_numpy(scale).to(base.device),
            torch.from_numpy(zero).to(base.device))


def encode_u8(base_f32, scale, zero, levels: int = 255):
    """Codes of the affine quantizer (round half to even, saturating) and
    the exact squared norms of the dequantized points -- the walk's metric."""
    c = torch.round((base_f32 - zero[None, :]) / scale[None, :])
    codes = torch.clamp(c, 0.0, float(levels)).to(torch.uint8)
    x_hat_sq = squared_norms(codes.to(torch.float32) * scale[None, :] + zero[None, :])
    return codes, x_hat_sq


def _assemble_blocks(codes, x_hat_sq, nbr, bits: int = 8):
    """Inline one adjacency table (one device gather): ([NG, CR, D] u8 code
    blocks, [NG, Kc] ids, [NG, Kc] dequantized squared norms).

    ``bits=4`` packs two neighbours per code row (low nibble = the even
    column), CR = Kc/2. The kernel's dot columns then come out [all low |
    all high], so ids and norms are stored in that same order (even
    columns, then odd); the walk only ever pairs id[j] with dot[j]."""
    safe = nbr.clamp_min(0).long()
    blocks = codes[safe]
    sq = torch.where(nbr >= 0, x_hat_sq[safe], EMPTY_DIST)
    if bits == 4:
        blocks = blocks[:, 0::2, :] | (blocks[:, 1::2, :] << 4)
        nbr = torch.cat([nbr[:, 0::2], nbr[:, 1::2]], dim=1)
        sq = torch.cat([sq[:, 0::2], sq[:, 1::2]], dim=1)
    return blocks, nbr.contiguous(), sq.contiguous()


def make_adjacency(codes, x_hat_sq, nbr, scale, zero) -> AdjacencyTables:
    """Inline one layer's adjacency: [N, K, D] neighbour codes (one device
    gather) and the neighbours' dequantized squared norms."""
    blocks, ids, sq = _assemble_blocks(codes, x_hat_sq, nbr)
    return AdjacencyTables(nbr_ids=ids, blocks=blocks, nbr_sq=sq,
                           scale=scale, zero=zero)


def graph_fingerprint(graph) -> np.ndarray:
    """32-byte blake2b digest of a graph's layer-0 adjacency, hashed over a
    contiguous int32 host copy (the JAX package hashes the same bytes)."""
    nbr0 = graph.neighbors[0]
    if isinstance(nbr0, torch.Tensor):
        nbr0 = nbr0.cpu().numpy()
    nbr0 = np.ascontiguousarray(nbr0, dtype=np.int32)
    digest = hashlib.blake2b(nbr0.tobytes(), digest_size=32).digest()
    return np.frombuffer(digest, dtype=np.uint8).copy()


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

    ``group``: nodes per block (a power of two; 2 pairs graph-nearest
    nodes, matched on the host). ``bits=4`` stores packed int4 codes: half
    the block bytes (the walk metric coarsens; the exact re-rank does not).
    ``quantizer``: the (scale, zero) the build already fitted on this base
    at 255 levels, if any; reused for ``bits=8`` only (int4 re-fits at 15).
    """
    nbr0 = graph.neighbors[0]
    if group <= 1:
        members = np.arange(nbr0.shape[0], dtype=np.int32)[:, None]
    else:
        members = match_groups(nbr0.cpu().numpy(), group)
    scale, zero = quantizer if quantizer is not None and bits == 8 else (None, None)
    return assemble_fused_index(base, graph, members=members, scale=scale,
                                zero=zero, bits=bits)


def assemble_fused_index(
    base: torch.Tensor,
    graph: Graph,
    *,
    members: np.ndarray,
    scale=None,
    zero=None,
    bits: int = 8,
) -> FusedIndex:
    """Assemble the device-resident index from a group matching (and
    optionally a stored quantizer, numpy or tensor). Deterministic given
    (base, graph, members[, scale, zero]): re-assembling from a meta
    sidecar reproduces the stored index bit for bit."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits} (4 or 8)")
    levels = 255 if bits == 8 else 15
    dev = base.device
    if scale is None or zero is None:
        scale, zero = quantizer_for(base, levels=levels)
    scale = torch.as_tensor(scale, dtype=torch.float32).to(dev)
    zero = torch.as_tensor(zero, dtype=torch.float32).to(dev)
    base_f32 = base.to(torch.float32)
    codes, x_hat_sq = encode_u8(base_f32, scale, zero, levels=levels)
    nbr0 = graph.neighbors[0]
    N, K = nbr0.shape
    members_np = np.asarray(members, dtype=np.int32)
    NG, G = members_np.shape
    if bits == 4 and (G * K) % 2:
        raise ValueError("bits=4 requires an even candidate count per block")
    group_of = np.zeros((N,), np.int32)
    valid = members_np >= 0
    group_of[members_np[valid]] = np.repeat(
        np.arange(NG, dtype=np.int32), G).reshape(NG, G)[valid]
    members_t = torch.from_numpy(members_np).to(dev)
    # member-major group adjacency: row g = [nbrs(m0) || nbrs(m1) ...]; an
    # empty member slot contributes empty ids
    grp_nbrs = torch.where((members_t >= 0)[:, :, None],
                           nbr0[members_t.clamp_min(0).long()],
                           EMPTY_ID).reshape(NG, G * K)
    blocks, ids, sq = _assemble_blocks(codes, x_hat_sq, grp_nbrs, bits=bits)
    rep_ids = graph.translation[1].to(torch.int32)
    rep_vecs = base_f32[rep_ids.long()]
    return FusedIndex(
        nbr_ids=ids,
        blocks=blocks,
        nbr_sq=sq,
        group_of=torch.from_numpy(group_of).to(dev),
        members=members_t,
        scale=scale,
        zero=zero,
        rep_ids=rep_ids,
        rep_vecs=rep_vecs,
        rep_sq=squared_norms(rep_vecs),
        nn1_stats=graph.nn1_stats.to(dev),
    )


def fused_index_matches_graph(index, graph, k_build: int) -> bool:
    """Whether a (possibly stale) index or its meta belongs to this graph.

    A full :class:`FusedIndex` must hold exactly its members' current
    layer-0 neighbour ids (in its fetch-column order). A
    :class:`FusedIndexMeta` re-derives its adjacency from the current graph
    at assembly, so it must carry this graph's fingerprint: a matching from
    another graph pairs badly and its quantizer may not fit this base."""
    nbr0 = graph.neighbors[0]
    nbr0 = nbr0.cpu().numpy() if isinstance(nbr0, torch.Tensor) else np.asarray(nbr0)
    N, K = nbr0.shape
    if K != k_build:
        return False
    m = index.members
    m = m.cpu().numpy() if isinstance(m, torch.Tensor) else np.asarray(m)
    if m.ndim != 2:
        return False
    flat = np.sort(m[m >= 0].ravel())
    if flat.shape != (N,) or not np.array_equal(flat, np.arange(N)):
        return False
    if isinstance(index, FusedIndexMeta):
        return bool(np.any(index.graph_fp)
                    and np.array_equal(index.graph_fp, graph_fingerprint(graph)))
    if index.k_build != K or tuple(index.group_of.shape) != (N,):
        return False
    expected = np.where((m >= 0)[:, :, None], nbr0[np.clip(m, 0, None)],
                        EMPTY_ID).reshape(m.shape[0], m.shape[1] * K)
    if index.bits == 4:
        expected = np.concatenate([expected[:, 0::2], expected[:, 1::2]], axis=1)
    return np.array_equal(index.nbr_ids.cpu().numpy(), expected)


def meta_of(index, graph=None) -> FusedIndexMeta:
    """The persistable meta of an index (host arrays of a few MB, never the
    inline-code tables). Pass the source ``graph`` to stamp the staleness
    fingerprint; without it the meta is rejected by any later load."""
    if isinstance(index, FusedIndexMeta):
        return index
    return FusedIndexMeta(
        members=index.members.cpu().numpy(),
        scale=index.scale.cpu().numpy(),
        zero=index.zero.cpu().numpy(),
        graph_fp=(graph_fingerprint(graph) if graph is not None
                  else np.zeros((32,), np.uint8)),
        bits=np.asarray([index.bits], np.int32),
    )


def save_fused_index(path, index, graph=None) -> None:
    """Write the index's meta as a ``.fused.npz`` sidecar (``meta-v2``: the
    JAX package reads it, and this reads the JAX package's). Pass ``graph``
    so that the sidecar carries the fingerprint a later load checks."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    m = meta_of(index, graph)
    header = {"format": "meta-v2", "n": int((np.asarray(m.members) >= 0).sum()),
              "group": int(m.members.shape[1])}
    np.savez(path, meta=json.dumps(header),
             **{k: np.asarray(v) for k, v in m._asdict().items()})


def load_fused_index(path) -> FusedIndexMeta:
    """Read a sidecar as its meta. A sidecar older than ``meta-v2`` (no
    ``graph_fp``) loads with an all-zeros fingerprint, which
    :func:`fused_index_matches_graph` rejects; one without ``bits`` is
    uint8."""
    with np.load(Path(path), allow_pickle=False) as f:
        vals = {}
        for k in FusedIndexMeta._fields:
            if k == "graph_fp" and k not in f:
                vals[k] = np.zeros((32,), np.uint8)
            elif k == "bits" and k not in f:
                vals[k] = np.asarray([8], np.int32)
            else:
                vals[k] = np.asarray(f[k])
        return FusedIndexMeta(**vals)


def _code_dists(q_vecs, q_sq, anchors, index, measure, zdot=None):
    """Distances from each row's query to its anchors' inline neighbours.

    anchors: [B, P] i32 (-1 = empty). Returns (ids [B, P*Kc], d [B, P*Kc]),
    Kc = index.cand_per_fetch. One contiguous block fetch per anchor's
    *group* -- THE hot memory access, run by the kernel on the card; anchors
    of a row that share a group collapse to one fetch (the later ones become
    empty, -1, blocks, whose lanes the kernel leaves unwritten). ``zdot``:
    the rows' ``q . zero`` [B], computed here when not given (a walk
    computes it once per tile, :func:`_zero_dots`).
    """
    B, P = anchors.shape
    Kc = index.cand_per_fetch
    group_of = getattr(index, "group_of", None)
    if group_of is not None and index.group > 1:
        blk = torch.where(anchors >= 0, group_of[anchors.clamp_min(0).long()],
                          EMPTY_ID)
        # keep the first anchor of each group in the row, blank the rest
        eq = blk[:, :, None] == blk[:, None, :]
        lower = torch.tril(torch.ones((P, P), dtype=torch.bool,
                                      device=blk.device), diagonal=-1)
        dup = torch.any(eq & lower[None] & (blk[:, None, :] >= 0), dim=-1)
        blk = torch.where(dup, EMPTY_ID, blk).contiguous()
    else:
        blk = anchors
    safe = blk.clamp_min(0).long()
    live = (blk >= 0)[:, :, None]
    ids = torch.where(live, index.nbr_ids[safe], EMPTY_ID).reshape(B, P * Kc)
    sq = torch.where(live, index.nbr_sq[safe], EMPTY_DIST).reshape(B, P * Kc)
    # dot(q, x_hat) = (q * scale) . codes + q . zero
    qs = q_vecs * index.scale[None, :]
    nibbles = index.blocks.shape[1] != Kc  # int4: two neighbours per row
    dot = adjacency_dot(qs, blk, index.blocks, nibbles=nibbles).reshape(B, P * Kc)
    if zdot is None:
        zdot = _zero_dots(q_vecs, index)
    dot = dot + zdot[:, None]
    d = finish(dot, q_sq[:, None], sq, measure)
    bad = (ids == EMPTY_ID) | ~torch.isfinite(sq)
    return ids, torch.where(bad, EMPTY_DIST, d)


def _zero_dots(q_vecs, index):
    """``q . zero`` of each query row: the dequantization offset's share of
    every dot product, one matrix-vector product per tile."""
    return q_vecs @ index.zero


def _fused_step(st: BeamState, q_vecs, q_sq, zdot, index, measure, *, k_best,
                P, cap):
    """One pop->fetch->filter->dedup->insert step of the quantized-adjacency
    walk (shared by the query engine and the construction merge).

    Distances are cheap here (computed from the inline codes), so the
    admission criterion filters BEFORE the dedup/merge: keep only the best
    ``cap`` candidates below best+xi, sorted."""
    anchors, active, st = beam_pop(st, P, k_best)
    ids, d = _code_dists(q_vecs, q_sq, anchors, index, measure, zdot)
    crit = st.criteria(k_best)
    ids, d = cap_candidates(ids, d, cap, criteria=crit)
    ok = beam_dedup_mask(st, ids)
    ids = torch.where(ok, ids, EMPTY_ID)
    st = beam_insert(st, ids, d, row_mask=active, criteria=crit)
    return st, active


def _default_cap(P: int, index) -> int:
    # a quarter of the raw tile survives criteria+dedup in steady state;
    # survivors beyond the cap cost at most a revisit
    return max(64, (P * index.cand_per_fetch) // 4)


def _walk(index, measure, *, k_best: int, P: int, cap: int, slack=None):
    """The walk's step over ``consts = (q, q_sq, q . zero[, xi0, tau])`` with
    the cache name and the tensors it reads, for :func:`graphs.run_steps`:
    the counterpart of the JAX package's ``body`` / ``cond`` pair."""

    def step(st, c):
        if slack is not None:
            st = st._replace(xi=Slack(c[3], c[4], slack.measure)(st))
        return _fused_step(st, c[0], c[1], c[2], index, measure,
                           k_best=k_best, P=P, cap=cap)

    layout = (index.cand_per_fetch, tuple(index.blocks.shape[1:]),
              getattr(index, "group", 1))
    name = ("fused", int(measure), k_best, P, cap, slack is not None, layout)
    reads = (index.blocks, index.nbr_ids, index.nbr_sq, index.scale, index.zero,
             getattr(index, "group_of", None))
    return step, name, reads


def fused_best_first(state, q_vecs, q_sq, index, measure, max_iterations: int,
                     k_best: int, pops_per_iter: int = 8, cap: int | None = None,
                     *, route: graphs.Route | None = None):
    """Best-first expansion over inline-code adjacency until convergence or
    the ``max_iterations`` pop budget; returns the final beam. ``route``:
    how the loop runs (:mod:`ggnn_torch.utils.graphs`; by default graphs
    on the card, the eager loop on the CPU)."""
    P = max(1, pops_per_iter)
    cap = _default_cap(P, index) if cap is None else cap
    step, name, reads = _walk(index, measure, k_best=k_best, P=P, cap=cap)
    B = q_vecs.shape[0]
    live = torch.ones((B,), dtype=torch.bool, device=q_vecs.device)
    state, *_ = graphs.run_steps(
        step, state, (q_vecs, q_sq, _zero_dots(q_vecs, index)), live, it=0,
        steps=-(-max_iterations // P), live_n=B, floor=0,
        route=graphs.resolve(route, q_vecs.device), name=name, reads=reads)
    return state


def fused_best_first_compacted(state, q_vecs, q_sq, index, measure,
                               max_iterations: int, k_best: int,
                               pops_per_iter: int = 8, cap: int | None = None,
                               compact_levels: int = 3, *,
                               route: graphs.Route | None = None):
    """:func:`fused_best_first` with converged-row compaction; returns the
    final ``k_best`` beam columns (ids, dists) per row. Used by the
    construction merge, whose rows run to convergence."""
    P = max(1, pops_per_iter)
    cap = _default_cap(P, index) if cap is None else cap
    return _best_first_phases(
        state, q_vecs, q_sq, index, measure,
        steps=-(-max_iterations // P), k_best=k_best, P=P, cap=cap,
        k_out=k_best, compact_levels=compact_levels, want_d=True, route=route,
    )


def _best_first_phases(state, q_vecs, q_sq, index, measure, *, steps: int,
                       k_best: int, P: int, cap: int, k_out: int,
                       compact_levels: int, slack: Slack | None = None,
                       want_d: bool = False, min_rows: int = 256,
                       route: graphs.Route | None = None,
                       live_rows: int | None = None):
    """The best-first sweep as PHASES of halving row counts.

    Rows walk independently, so once enough rows of the lock-step tile have
    converged the live rows move into a half-size sub-tile that keeps
    stepping. Every live row still receives its full pop budget, so results
    are identical to the single-phase sweep -- but converged rows stop paying
    the per-step cost (the reference's free per-block exit,
    query_layer.cu:57-79). A phase is the JAX package's ``run_phase``: on
    the card its steps replay as CUDA graphs and the host reads the live
    count once per replay (``graphs.run_steps``); a row that converged
    inside a replay keeps its beam through the replay's remaining steps, so
    the results are those of the per-step loop. ``slack``: the query's
    dynamic slack, applied before each pop. ``live_rows``: only the first
    that many rows walk; the rest pad the tile and start dead.

    Returns the first ``k_out`` beam columns per original row:
    (ids [B, k_out], dists [B, k_out] or None if not ``want_d``).
    """
    B = q_vecs.shape[0]
    dev = q_vecs.device
    route = graphs.resolve(route, dev)
    caps = [B]
    for _ in range(max(0, compact_levels)):
        if caps[-1] // 2 >= min_rows:
            caps.append(caps[-1] // 2)
    step, name, reads = _walk(index, measure, k_best=k_best, P=P, cap=cap,
                              slack=slack)
    scalars = () if slack is None else (slack.xi0, slack.tau)

    live_n = B if live_rows is None else live_rows
    live = torch.arange(B, device=dev) < live_n
    it = 0
    # while a profiler records: the anchors the steps hand the adjacency
    # kernel, as the entries each phase adds to the visited ring (one a
    # pop; a full ring counts no more). Only where an anchor is a fetch of
    # its own: a group's members share one.
    tally = None
    if recording() and getattr(index, "group", 1) == 1:
        tally = adjacency_variant(index.blocks.shape[2],
                                  index.blocks.shape[1] != index.cand_per_fetch)
    # per-row constants, selected with the rows at each compaction
    st, rows_c = state, (q_vecs, q_sq, _zero_dots(q_vecs, index))
    idx = torch.arange(B, device=dev)  # original row of each tile row
    out_i = st.i[:, :k_out].clone()
    out_d = st.d[:, :k_out].clone() if want_d else None
    for pi, rows in enumerate(caps):
        next_min = caps[pi + 1] if pi + 1 < len(caps) else 0
        if pi:
            # stable sort brings live rows to the front in original order;
            # the previous phase exited with <= ``rows`` live rows (or out of
            # budget, and then the phase below runs zero steps)
            order = torch.argsort((~live).to(torch.int8), stable=True)
            sel = order[:rows]
            st = st.select(sel)
            rows_c = tuple(t[sel] for t in rows_c)
            live, idx = live[sel], idx[sel]
        if tally is not None:
            ring = torch.count_nonzero(st.vis != EMPTY_ID)
        st, live, it, live_n = graphs.run_steps(
            step, st, rows_c + scalars, live, it=it, steps=steps,
            live_n=live_n, floor=next_min, route=route, name=name, reads=reads)
        if tally is not None:
            count_fetched(tally, torch.count_nonzero(st.vis != EMPTY_ID) - ring)
        out_i[idx] = st.i[:, :k_out]
        if want_d:
            out_d[idx] = st.d[:, :k_out]
    return out_i, out_d


@torch.no_grad()
def _fused_query_tile(q_vecs, index: FusedIndex, base, base_sq, tau, *,
                      width: int, vis_size: int, k_query: int,
                      measure: DistanceMeasure, max_iterations: int,
                      pops_per_iter: int, num_seeds: int, rerank: int,
                      cap: int, compact_levels: int, route=None,
                      rows: int | None = None, seed_approx: bool = False):
    """One tile's seed, walk and re-rank; only its first ``rows`` rows are
    queries (all by default), the rest pad it to its planned size: they
    are not seeded, so their walk is dead from the first pop. Each stage
    is a span (``utils/spans.py``): ``seed``, ``walk``, ``rerank``.
    ``seed_approx``: the seeds are ``jax.lax.approx_min_k``'s as the TPU
    computes it (``ops/approx_topk.py``), else the exact top-k."""
    B = q_vecs.shape[0]
    P = pops_per_iter
    q_vecs = q_vecs.to(torch.float32)
    q_sq = torch.sum(q_vecs * q_vecs, dim=-1)

    # dynamic slack (query_layer.cu:48-63): from the max 1-NN distance,
    # tightened by the current best distance
    nn1 = index.nn1_stats
    if measure == DistanceMeasure.Euclidean:
        xi0 = (nn1[1] * nn1[1]) * tau * tau
    else:
        xi0 = nn1[1] * tau
    slack = Slack(xi0, tau, measure)

    state = beam_init(B, width, xi0, vis_size, device=q_vecs.device)

    # seed: dense rep scan, the best num_seeds enter the beam
    with span("seed"):
        if seed_approx:
            seed_d, pos = dist_approx_smallest_k(
                q_vecs, index.rep_vecs, num_seeds, measure, q_sq=q_sq,
                c_sq=index.rep_sq)
        else:
            seed_d_all = dist_block(q_vecs, index.rep_vecs, measure, q_sq=q_sq,
                                    c_sq=index.rep_sq)
            seed_d, pos = smallest_k_positions(seed_d_all, num_seeds)
            del seed_d_all  # [B, n]: not held through the walk
        seed_ids = index.rep_ids[pos]
        no_crit = torch.full((B,), EMPTY_DIST, device=q_vecs.device)
        real = (None if rows is None or rows == B
                else torch.arange(B, device=q_vecs.device) < rows)
        state = beam_insert(state, seed_ids, seed_d, real, criteria=no_crit)

    R = min(rerank, width)
    with span("walk"):
        result_i, _ = _best_first_phases(
            state, q_vecs, q_sq, index, measure,
            steps=-(-max_iterations // P), k_best=k_query, P=P, cap=cap,
            k_out=R, compact_levels=compact_levels, slack=slack, route=route,
            live_rows=rows,
        )

    # exact re-rank of the top survivors (the fused gather + distance)
    with span("rerank"):
        d, _ = gather_dist(q_vecs[:, None], q_sq[:, None], result_i, base,
                           base_sq, None, measure, with_ids=False)
        d = torch.where(result_i == EMPTY_ID, EMPTY_DIST, d[:, 0])
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
    route: graphs.Route | None = None,
    seed_approx: bool = False,
):
    """Query one shard through its quantized-adjacency index.

    Same user parameters as the reference query (KQuery, tau_query,
    max_iterations -- the total anchor-pop budget, ggnn.cuh:144-155).
    Queries run in tiles of ``chunk`` rows, the last one padded by
    :func:`tile_plan`; each tile is the span ``tile[<rows>/<tile rows>]``.
    ``route``: how the walk's loop runs
    (:mod:`ggnn_torch.utils.graphs`): by default as CUDA graphs on the card
    and eagerly on the CPU; ``graphs.EAGER`` is the plain version.
    ``seed_approx``: pick the seeds as the TPU's ``approx_min_k`` does
    (recall target 0.95; ``ops/approx_topk.py``) instead of the exact top-k.

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
    outs = []
    for lo, rows, tile in tile_plan(Q, chunk, dev):
        with span("tile[%d/%d]", rows, tile):
            ids, dists = _fused_query_tile(
                pad_rows(query[lo : lo + rows], tile), index, base, base_sq,
                tau, width=width, vis_size=vis_size, k_query=KQuery,
                measure=measure, max_iterations=max_iterations,
                pops_per_iter=P, num_seeds=num_seeds, rerank=rerank, cap=cap,
                compact_levels=max(0, compact_levels), route=route, rows=rows,
                seed_approx=seed_approx,
            )
            outs.append((ids[:rows], dists[:rows]))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def tile_plan(Q: int, chunk: int, device="cuda") -> list[tuple[int, int, int]]:
    """(first row, rows, tile rows) of each tile of a ``Q``-row batch on
    ``device`` (the JAX package's chunk plan): tiles of ``chunk`` rows, the
    last padded only to the next power of two, at least 256 (a batch below
    ``chunk`` is one such tile). Every batch size then walks one of a few
    tile shapes -- and replays one of a few sets of captured programs. Where
    :func:`_padded` says no (the CPU), each tile walks its own rows."""
    def rounded(n):
        return max(256, 1 << (n - 1).bit_length()) if _padded(device) else n

    chunk = min(chunk, rounded(Q))
    return [(lo, min(chunk, Q - lo), min(chunk, rounded(min(chunk, Q - lo))))
            for lo in range(0, Q, chunk)]


def _padded(device) -> bool:
    """Whether tiles on ``device`` are padded: on the card, where each tile
    shape is a set of captured programs, on both routes alike (the same
    shapes, the same library kernels); the CPU captures nothing."""
    return torch.device(device).type == "cuda"


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows``."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0], *x.shape[1:]))])
