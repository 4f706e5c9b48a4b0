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

The id dedup of every walk step, and on the row and sym walks the dedup
fused with the compaction of the survivors, run as a hand-written Hopper
kernel on CUDA tensors (:func:`beam_dedup_mask`, :func:`beam_dedup_compact`;
``csrc/beam_dedup.cu``, built by ``utils/nvcc.py`` at first use); CPU
tensors take the plain versions :func:`beam_dedup_mask_plain` and
:func:`beam_compact_candidates_plain`, which are also the kernel's oracle.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from ggnn_torch.config import DistanceMeasure
from ggnn_torch.utils import graphs, nvcc

__all__ = [
    "BeamState",
    "Slack",
    "beam_init",
    "beam_dedup_mask",
    "beam_dedup_mask_plain",
    "beam_dedup_compact",
    "beam_compact_candidates_plain",
    "beam_insert",
    "beam_pop",
    "beam_transform",
]

EMPTY_ID = -1
EMPTY_DIST = float("inf")

KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "beam_dedup.cu"
# shared memory a block may use on an H100 (227 KB, opted in above 48 KB):
# one row's hash table of 2^14 slots at most (K <= 8192; <= 4096 where the
# table is doubled for a long seen list)
MAX_SHARED_BYTES = 232_448
# rows (one warp each) of a kernel block at most, and the shared memory a
# block aims under (``csrc/beam_dedup.cu``: kMaxWarps, kSmemTarget)
MAX_ROWS_PER_BLOCK = 8
SMEM_TARGET = 48 * 1024

# launches of the dedup kernel (the plain CPU route does not count): all of
# them, and those that also compact; updated under ``_count_lock``, and a
# launch captured into a CUDA graph counts once per replay of that graph
# (``graphs.count_launch``), as ``ops/adjacency.py`` counts its kernel
launches = 0
launches_compact = 0

_launch_fns = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


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


def beam_dedup_mask_plain(
    state: BeamState,
    cand_i: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Which candidates are new to the beam (the id-only part of ``fetch``):
    the plain version of the dedup kernel.

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


def beam_compact_candidates_plain(cand_i: torch.Tensor, ok: torch.Tensor,
                                  cap: int):
    """Pack the surviving candidates left and truncate to ``cap`` columns:
    the plain version of the compaction that the dedup kernel fuses.

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


def library_path() -> Path:
    """The dedup kernel's shared library: named by the hash of its source
    and the nvcc flags, in the cache directory (``utils/nvcc.py``)."""
    return nvcc.library_path("beam_dedup", KERNEL_SOURCE)


def build_kernel() -> float:
    """Compile the dedup kernel's library unless the library of this source
    and these flags exists. Returns the seconds the build took (0.0 when it
    was there)."""
    return nvcc.build("beam_dedup", KERNEL_SOURCE)


def kernel_resources():
    """Registers, shared and local (spill) bytes of the built dedup
    kernels; None where ``cuobjdump`` is missing."""
    return nvcc.kernel_resources(library_path())


def _bind(path: Path):
    """The C entry points (``beam_dedup_launch``,
    ``beam_dedup_compact_launch``) of a built library."""
    lib = ctypes.CDLL(str(path))
    ptr, ld, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    inputs = [ptr, ld] * 4  # cand, valid, beam ids, ring: pointer, row stride
    mask = lib.beam_dedup_launch
    mask.argtypes = inputs + [ptr] + [i32] * 4 + [ptr]
    compact = lib.beam_dedup_compact_launch
    compact.argtypes = inputs + [ptr, ptr] + [i32] * 5 + [ptr]
    mask.restype = compact.restype = ctypes.c_int
    return mask, compact


def _load():
    global _launch_fns
    with _lib_lock:
        if _launch_fns is None:
            build_kernel()
            _launch_fns = _bind(library_path())
    return _launch_fns


def table_slots(K: int, W: int, V: int) -> int:
    """Slots of a row's hash table in the kernel, 8 bytes each (an id and
    its first column): the least power of two >= max(32, 2K), or >= 4K
    where the row's seen ids (W + V) outnumber 8K."""
    want = (4 if W + V > 8 * K else 2) * K
    return 1 << max(5, (want - 1).bit_length())


def rows_per_block(K: int, W: int, V: int) -> int:
    """Rows (one warp each) of a kernel block: ``MAX_ROWS_PER_BLOCK``,
    halved while the block's tables exceed ``SMEM_TARGET``, at least 1."""
    r = MAX_ROWS_PER_BLOCK
    while r > 1 and r * 8 * table_slots(K, W, V) > SMEM_TARGET:
        r //= 2
    return r


def shared_bytes(K: int, W: int, V: int) -> int:
    """Dynamic shared memory of a kernel block: a hash table per row,
    sized by K (doubled for long seen lists); the seen ids are never staged
    (``csrc/beam_dedup.cu``)."""
    return rows_per_block(K, W, V) * 8 * table_slots(K, W, V)


def register_chunks(K: int) -> int:
    """32-column chunks of candidates a kernel lane holds in registers, the
    kernel's template argument: 1 up to K = 32, 3 up to 96, else 12 (K
    above 384 runs in passes)."""
    return 1 if K <= 32 else 3 if K <= 96 else 12


def _rows(t: torch.Tensor, name: str) -> int:
    """The row stride of a [B, n] tensor whose rows are contiguous."""
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"beam dedup kernel: {name} must be [B, n] with "
                         f"contiguous rows, got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")
    return t.stride(0)


def _check(state: BeamState, cand_i, valid):
    devs = {t.device for t in (state.i, state.vis, cand_i)}
    if valid is not None:
        devs.add(valid.device)
    if len(devs) != 1:
        raise ValueError(f"beam dedup: inputs on several devices {devs}")
    B = cand_i.shape[0]
    if cand_i.dim() != 2 or state.i.shape[0] != B or state.vis.shape[0] != B:
        raise ValueError(f"beam dedup: candidates {tuple(cand_i.shape)} against "
                         f"beam {tuple(state.i.shape)}, ring {tuple(state.vis.shape)}")
    if valid is not None and valid.shape != cand_i.shape:
        raise ValueError(f"beam dedup: valid {tuple(valid.shape)} against "
                         f"candidates {tuple(cand_i.shape)}")
    return devs.pop()


def _launch(state: BeamState, cand_i, valid, cap):
    """The kernel on CUDA tensors: ok [B, K] and, with ``cap``, packed
    [B, min(cap, K)]."""
    for t, name in ((cand_i, "candidates"), (state.i, "beam ids"),
                    (state.vis, "ring")):
        if t.dtype != torch.int32:
            raise ValueError(f"beam dedup kernel: {name} must be int32, got {t.dtype}")
    if valid is not None and valid.dtype != torch.bool:
        raise ValueError(f"beam dedup kernel: valid must be bool, got {valid.dtype}")
    B, K = cand_i.shape
    W, V = state.i.shape[1], state.vis.shape[1]
    compact = cap is not None
    smem = shared_bytes(K, W, V)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"beam dedup kernel: K={K}, W={W}, V={V} need {smem} B "
                         f"of shared memory a block, above {MAX_SHARED_BYTES}")
    strides = [_rows(cand_i, "candidates"), _rows(state.i, "beam ids"),
               _rows(state.vis, "ring")]
    ld_valid = 0 if valid is None else _rows(valid, "valid")
    dev = cand_i.device
    ok = torch.empty((B, K), dtype=torch.bool, device=dev)
    packed = (torch.empty((B, min(cap, K)), dtype=torch.int32, device=dev)
              if compact else None)
    if B == 0 or K == 0:
        return ok, packed
    mask_fn, compact_fn = _load()
    args = [cand_i.data_ptr(), strides[0],
            None if valid is None else valid.data_ptr(), ld_valid,
            state.i.data_ptr(), strides[1], state.vis.data_ptr(), strides[2]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if compact:
            err = compact_fn(*args, ok.data_ptr(), packed.data_ptr(), B, K, W,
                             V, int(cap), stream)
        else:
            err = mask_fn(*args, ok.data_ptr(), B, K, W, V, stream)
    if err:
        raise RuntimeError(f"beam dedup kernel launch failed: CUDA error {err}")
    graphs.count_launch(_count, compact)
    return ok, packed


def _count(compact: bool) -> None:
    global launches, launches_compact
    with _count_lock:
        launches += 1
        launches_compact += compact


def beam_dedup_mask(
    state: BeamState,
    cand_i: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Which candidates are new to the beam: [B, K] bool, True where
    ``cand_i`` is not EMPTY, passes ``valid``, differs from every earlier
    candidate of its row and is in neither the beam nor the visited ring.

    CPU tensors take :func:`beam_dedup_mask_plain`; CUDA tensors launch the
    kernel (``csrc/beam_dedup.cu``), which needs int32 ids, a bool
    ``valid`` and rows with contiguous elements; another device raises.
    """
    dev = _check(state, cand_i, valid)
    if dev.type == "cpu":
        return beam_dedup_mask_plain(state, cand_i, valid)
    if dev.type != "cuda":
        raise ValueError(f"beam_dedup_mask: unsupported device {dev}")
    return _launch(state, cand_i, valid, None)[0]


def beam_dedup_compact(
    state: BeamState,
    cand_i: torch.Tensor,
    valid: torch.Tensor | None,
    cap: int,
):
    """The dedup and the compaction in one pass: (ok [B, K] bool as
    :func:`beam_dedup_mask`, the surviving ids packed left in column order
    [B, min(cap, K)] i32 with EMPTY padding, as
    :func:`beam_compact_candidates_plain`). Dispatch as
    :func:`beam_dedup_mask`."""
    dev = _check(state, cand_i, valid)
    if dev.type == "cpu":
        ok = beam_dedup_mask_plain(state, cand_i, valid)
        return ok, beam_compact_candidates_plain(cand_i, ok, cap)
    if dev.type != "cuda":
        raise ValueError(f"beam_dedup_compact: unsupported device {dev}")
    return _launch(state, cand_i, valid, cap)


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
