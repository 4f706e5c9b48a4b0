"""Approximate k smallest distances of a dense tile: the seeding's top-k.

The JAX package picks its seeds with ``jax.lax.approx_min_k`` (the fused
query with ``seed_approx``, ``ggnn_tpu/query/fused.py:758``; every
dense-seeded build merge, ``ggnn_tpu/build/merge.py:108``). On the TPU XLA
lowers it to its ``ApproxTopK`` partial reduction (Chern et al.,
"TPU-KNN: K Nearest Neighbor Search at Peak FLOP/s", NeurIPS 2022); on the
CPU and the GPU JAX falls back to the exact top-k. This module is the
TPU's version, with ``recall_target=0.95`` and ``aggregate_to_topk=True``.
For each row of ``n`` distances and a given ``k``:

1. **Reduction size** ``M`` (:func:`reduction_size`): XLA's
   ``ApproxTopKReductionOutputSize`` with 128-lane tiling. ``M = n`` when
   ``n <= 128`` or ``recall_target >= 1``; ``M = 128`` when ``k == 1``;
   otherwise ``m = min(max(int((1 - k) / ln r), 128), n)``, ``lr =
   floor(log2(n // m))`` (``M = n`` if 0), ``lr = min(lr, ceil(log2(n /
   128)))`` and ``M = ceil(ceil(n / 128) / 2**lr) * 128``.
2. **Partial reduction.** Position ``c`` of the row falls into bin ``c mod
   M``; each bin keeps its smallest ``(distance, c)``, ordered by distance
   then position. ``M`` is a multiple of 128, so this folds whole 128-lane
   tiles onto each other (the paper's strided PartialReduce; the bin
   assignment is this port's reading of the paper and of XLA's tiling,
   which a CPU cannot check: there the op is exact).
3. **Aggregation.** The exact ``k`` smallest of the ``M`` bin winners,
   ascending by ``(distance, position)``.

Where ``M == n`` (or ``k > M``) no reduction happens and the result is the
exact top-k in that order. A NaN distance counts as ``+inf`` (a bin of NaN
only keeps its first position, at ``+inf``). The result is deterministic,
so the kernel and its plain version agree entry for entry.

:func:`dist_approx_smallest_k` is the seeding's entry point: the dot
products by cuBLAS (``torch.matmul``; the JAX package leaves them to XLA
in ``dist_block``), then on a CUDA tensor one launch of the hand-written
Hopper kernel ``csrc/approx_topk.cu``, which fuses ``finish``'s distance
epilogue, the partial reduction and the aggregation; on a CPU tensor
``finish`` and :func:`approx_smallest_k_plain`. There is no other route: a
failed build or launch raises.

The kernel is bound by the bytes of the ``[B, n]`` product, read once.
Measured on an H100, its first design lost its time to 4-byte loads, to k
block-barrier rounds per row at k = 32 and to the ramp of a short tile
(``PERF.md``). The reducing rows with ``k <= 32`` (every seeding shape)
now take one warp a row, 4 rows a block (:func:`kernel_layout`): thread 0
streams a batch of each row and of the norms into a ring of shared-memory
stages by bulk copies (1-D TMA, mbarriers), so the bytes in flight cost no
registers; lane ``l`` owns bins ``4l .. 4l + 3`` of every 128-wide
sub-tile and keeps each bin's minimum in registers; the k smallest winners
are taken inside the warp with no barrier, as 64-bit keys
(:func:`order_keys`: one integer compare orders by (distance, position))
inserted into a list sorted across the lanes; a grid of the blocks the
card holds at once. The bulk copies need 16-byte aligned rows, so
:func:`seeding_product` writes the product at a row stride rounded up to
4. The exact rows (``M == n``), ``k > 32`` and unaligned rows keep the
first design, one 128-thread block a row.
"""

from __future__ import annotations

import ctypes
import math
import threading
from dataclasses import dataclass
from pathlib import Path

import torch

from ggnn_torch.config import DistanceMeasure
from ggnn_torch.ops.distance import finish
from ggnn_torch.utils import graphs, nvcc

__all__ = [
    "RECALL_TARGET",
    "approx_smallest_k",
    "approx_smallest_k_plain",
    "build_kernel",
    "dist_approx_smallest_k",
    "kernel_layout",
    "kernel_resources",
    "library_path",
    "order_keys",
    "reduction_size",
    "seeding_product",
]

KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "approx_topk.cu"
# ``jax.lax.approx_min_k``'s default, which both seeding sites keep
RECALL_TARGET = 0.95
# shared memory a block may use on an H100 (227 KB, opted in above 48 KB):
# the block kernel's M bin winners, 8 bytes each; a row that needs more is
# refused here, before a launch
MAX_SHARED_BYTES = 232_448
# the kernels' block (``csrc/approx_topk.cu``: ``kThreads``); the warp
# kernel's ring: stages (``kStages``), 16-byte pieces a lane a stage
# (``kBatch``), and its shared memory, a stage holding a batch of each of
# the block's rows and of the norms
THREADS = 128
STAGES = 2
BATCH = 8
RING_BYTES = STAGES * (THREADS // 32 + 1) * BATCH * 32 * 16

# launches of the kernel (the plain CPU route does not count), updated
# under ``_count_lock``; a launch captured into a CUDA graph counts once per
# replay (``graphs.count_launch``)
launches = 0

_launch_fn = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def reduction_size(n: int, k: int, recall_target: float = RECALL_TARGET) -> int:
    """Bins ``M`` of a row of ``n`` for the ``k`` smallest at
    ``recall_target`` (XLA's ``ApproxTopKReductionOutputSize``, 128-lane
    tiles); ``n`` where no reduction happens."""
    if n <= 128 or recall_target >= 1.0:
        return n
    if k == 1:
        return 128
    m = min(max(int((1 - k) / math.log(recall_target)), 128), n)
    lr = int(math.floor(math.log2(n // m)))
    if lr == 0:
        return n
    lr = min(lr, int(math.ceil(math.log2(n / 128))))
    return -(-(-(-n // 128)) // (1 << lr)) * 128


def _bins(n: int, k: int) -> int:
    """The bins the kernel and the plain version reduce into: ``n`` where
    :func:`reduction_size` leaves ``k`` bins or fewer (exact)."""
    M = reduction_size(n, k)
    return n if k > M else M


def order_keys(d: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit keys of (distance, position) pairs (int64, the
    shape of ``d``): an order-preserving map of the f32 distance's bits (NaN
    as ``+inf``, ``-0.0`` as ``0.0``) shifted up 32, or'ed with the position
    (``0 <= pos < 2**31``), so that one signed compare orders as the pair."""
    d = torch.where(d.isnan(), float("inf"), d).contiguous()
    s = d.view(torch.int32)
    s = torch.where(s == -(1 << 31), 0, s)
    s = torch.where(s < 0, s ^ 0x7FFFFFFF, s)
    return (s.to(torch.int64) << 32) | pos.to(torch.int64)


def approx_smallest_k_plain(dists: torch.Tensor, k: int):
    """The plain version of the kernel over a ``[B, n]`` distance tile:
    (dists [B, k] f32, positions [B, k] i32), ascending by (distance,
    position), of the ``k`` smallest bin winners (module docstring)."""
    B, n = dists.shape
    if not 0 < k <= n:
        raise ValueError(f"approx top-k: k={k} outside 1..n={n}")
    M = _bins(n, k)
    T = -(-n // M)
    inf = float("inf")
    pad = torch.full((B, T * M - n), inf, dtype=dists.dtype, device=dists.device)
    # [B, T, M]: tile t holds positions t*M .. t*M + M - 1; min over t keeps
    # the first (lowest-position) of equal distances; NaN counts as +inf
    # (torch.min would carry it)
    d = torch.cat([torch.where(dists.isnan(), inf, dists), pad], dim=1)
    wd, wt = d.view(B, T, M).min(dim=1)
    wpos = wt * M + torch.arange(M, device=dists.device)
    # (distance, position) order: one sort of the winners' keys
    o = torch.sort(order_keys(wd, wpos), dim=-1).indices[:, :k]
    return torch.gather(wd, -1, o), torch.gather(wpos, -1, o).to(torch.int32)


def library_path() -> Path:
    """The kernel's shared library: named by the hash of its source and
    the nvcc flags, in the cache directory (``utils/nvcc.py``)."""
    return nvcc.library_path("approx_topk", KERNEL_SOURCE)


def build_kernel() -> float:
    """Compile the kernel's library unless the library of this source and
    these flags exists. Returns the seconds the build took (0.0 when it was
    there)."""
    return nvcc.build("approx_topk", KERNEL_SOURCE)


def kernel_resources():
    """Registers, shared and local (spill) bytes of the built kernels;
    None where ``cuobjdump`` is missing."""
    return nvcc.kernel_resources(library_path())


def _bind(lib_path):
    """The C entry point ``approx_topk_launch`` of a built library (this
    tree's, or another build of the same interface: ``approx_bench.py``)."""
    fn = ctypes.CDLL(str(lib_path)).approx_topk_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # dot, its row stride, q_sq, c_sq, out d, out pos, B, n, M, k, measure,
    # stream
    fn.argtypes = [ptr, ctypes.c_longlong, ptr, ptr, ptr, ptr,
                   i32, i32, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def _load():
    global _launch_fn
    with _lib_lock:
        if _launch_fn is None:
            build_kernel()
            _launch_fn = _bind(library_path())
    return _launch_fn


def _count() -> None:
    global launches
    with _count_lock:
        launches += 1


@dataclass(frozen=True)
class Layout:
    """How the kernel lays out a row of ``n`` at ``k`` (mirrored from
    ``csrc/approx_topk.cu``'s launcher)."""

    kernel: str          # "warp" (reducing rows, k <= 32) or "block"
    rows_per_block: int  # warp: 4 rows of a warp each; block: 1
    lanes_per_row: int   # the threads that share a row: 32 or 128
    bins_per_lane: int   # bins a thread holds in registers a pass
    passes: int          # passes over the row's columns
    tiles_per_batch: int  # warp: tiles a stage of the ring brings
    shared_bytes: int    # dynamic shared memory a block
    template: str        # the kernel instance, as its name is mangled


def kernel_layout(n: int, k: int, aligned: bool = True,
                  measure: DistanceMeasure = DistanceMeasure.Euclidean) -> Layout:
    """The kernel and layout that a launch at ``(n, k)`` takes (the warp
    kernel's instance also by ``measure``, a template argument).
    ``aligned``: the rows and the norms are 16-byte aligned (a row stride
    that is a multiple of 4, as :func:`seeding_product` makes it), which the
    warp kernel's bulk copies need. Its lane holds 4 bins of each of its
    NSUB 128-wide sub-tiles (the tile's ``M / 128`` rounded up to 1, 2, 4 or
    8; more take passes of 8) and a stage of its ring brings ``BATCH /
    NSUB`` tiles; the block kernel's thread holds 1, 2, 4 or 8 bins (passes
    of 8) and the row's winners sit in shared memory."""
    M = _bins(n, k)
    if M < n and M % 128 == 0 and k <= 32 and aligned:
        G = M // 128
        nsub = next(s for s in (1, 2, 4, 8) if G <= s or s == 8)
        return Layout("warp", THREADS // 32, 32, 4 * nsub, -(-G // nsub),
                      BATCH // nsub, RING_BYTES,
                      f"approx_topk_kernel_warpILi{nsub}ELi{int(measure)}EE")
    per_thread = -(-M // THREADS)
    rb = next(r for r in (1, 2, 4, 8) if per_thread <= r or r == 8)
    return Layout("block", 1, THREADS, rb, -(-per_thread // rb), 1, 8 * M,
                  f"approx_topk_kernel_blockILi{rb}EE")


def _launch(dot, q_sq, c_sq, k, measure):
    B, n = dot.shape
    for t, name in ((dot, "dot"), (q_sq, "q_sq"), (c_sq, "c_sq")):
        if t.dtype != torch.float32:
            raise ValueError(f"approx top-k kernel: {name} must be float32, "
                             f"got {t.dtype}")
    if q_sq.shape != (B,) or c_sq.shape != (n,):
        raise ValueError(f"approx top-k kernel: q_sq {tuple(q_sq.shape)} and "
                         f"c_sq {tuple(c_sq.shape)} against dot {(B, n)}")
    if n > 1 and dot.stride(1) != 1:
        raise ValueError(f"approx top-k kernel: dot's rows must be contiguous, "
                         f"got strides {dot.stride()}")
    M = _bins(n, k)
    smem = kernel_layout(n, k).shared_bytes
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"approx top-k kernel: {M} bins (n={n}, k={k}) need "
                         f"{smem} B of shared memory a block, above "
                         f"{MAX_SHARED_BYTES}")
    q_sq, c_sq = q_sq.contiguous(), c_sq.contiguous()
    if c_sq.data_ptr() % 16:  # a view at an odd offset: the warp kernel's
        c_sq = c_sq.clone()   # bulk copies need 16-byte aligned norms
    out_d = torch.empty((B, k), dtype=torch.float32, device=dot.device)
    out_p = torch.empty((B, k), dtype=torch.int32, device=dot.device)
    if B == 0:
        return out_d, out_p
    fn = _load()
    with torch.cuda.device(dot.device):
        stream = torch.cuda.current_stream(dot.device).cuda_stream
        err = fn(dot.data_ptr(), dot.stride(0), q_sq.data_ptr(),
                 c_sq.data_ptr(), out_d.data_ptr(), out_p.data_ptr(), B, n, M,
                 k, int(measure), stream)
    if err:
        raise RuntimeError(f"approx top-k kernel launch failed: CUDA error {err}")
    graphs.count_launch(_count)
    return out_d, out_p


def approx_smallest_k(dot: torch.Tensor, q_sq: torch.Tensor,
                      c_sq: torch.Tensor, k: int,
                      measure: DistanceMeasure = DistanceMeasure.Euclidean):
    """The approximate ``k`` smallest distances of each row, from the dot
    products ``dot [B, n]`` and the squared norms ``q_sq [B]``, ``c_sq
    [n]``: (dists [B, k] f32, positions [B, k] i32), ascending by
    (distance, position). CPU tensors take ``finish`` and
    :func:`approx_smallest_k_plain`; CUDA tensors launch the kernel
    (float32, rows with contiguous elements); another device raises."""
    measure = DistanceMeasure(measure)
    B, n = dot.shape
    if not 0 < k <= n:
        raise ValueError(f"approx top-k: k={k} outside 1..n={n}")
    dev = dot.device
    if dev.type == "cpu":
        d = finish(dot, q_sq[:, None], c_sq[None, :], measure)
        return approx_smallest_k_plain(d, k)
    if dev.type != "cuda":
        raise ValueError(f"approx top-k: unsupported device {dev}")
    return _launch(dot, q_sq, c_sq, k, measure)


def dist_approx_smallest_k(q: torch.Tensor, c: torch.Tensor, k: int,
                           measure: DistanceMeasure = DistanceMeasure.Euclidean,
                           *, q_sq: torch.Tensor, c_sq: torch.Tensor):
    """The seeding's scan: ``jax.lax.approx_min_k(dist_block(q, c), k)`` as
    the TPU computes it. ``q [B, D]``, ``c [n, D]`` (cast to f32), their
    squared norms ``q_sq [B]``, ``c_sq [n]``. Returns (dists [B, k],
    positions [B, k] i32 into ``c``), see :func:`approx_smallest_k`."""
    dot = seeding_product(q, c)
    return approx_smallest_k(dot, q_sq, c_sq, k, measure)


def seeding_product(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``q @ c.T`` in f32 (cuBLAS on the card), ``[B, n]``. On a CUDA device
    its rows start 16-byte aligned: where ``n % 4 != 0`` the product is
    written into a buffer of ``n`` rounded up to 4 columns and returned as
    the ``[:, :n]`` view, so that the kernel's bulk copies can take it."""
    q, c = q.to(torch.float32), c.to(torch.float32)
    n = c.shape[0]
    if q.device.type != "cuda" or n % 4 == 0:
        return q @ c.T
    buf = torch.empty((q.shape[0], -(-n // 4) * 4), dtype=torch.float32,
                      device=q.device)
    return torch.matmul(q, c.T, out=buf[:, :n])
