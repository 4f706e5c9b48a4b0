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
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path

import torch

from ggnn_torch.config import DistanceMeasure
from ggnn_torch.ops.distance import finish
from ggnn_torch.utils import graphs, nvcc

__all__ = [
    "RECALL_TARGET",
    "approx_smallest_k",
    "approx_smallest_k_plain",
    "bins_per_pass",
    "build_kernel",
    "dist_approx_smallest_k",
    "kernel_resources",
    "library_path",
    "reduction_size",
    "shared_bytes",
]

KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "approx_topk.cu"
# ``jax.lax.approx_min_k``'s default, which both seeding sites keep
RECALL_TARGET = 0.95
# shared memory a block may use on an H100 (227 KB, opted in above 48 KB):
# the M bin winners, 8 bytes each; a row that needs more is refused here,
# before a launch
MAX_SHARED_BYTES = 232_448

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
    # (distance, position) order: a stable sort by distance of the winners
    # in position order
    wpos, o = torch.sort(wpos, dim=-1)
    wd = torch.gather(wd, -1, o)
    wd, o = torch.sort(wd, dim=-1, stable=True)
    return wd[:, :k], torch.gather(wpos, -1, o[:, :k]).to(torch.int32)


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


def _load():
    global _launch_fn
    with _lib_lock:
        if _launch_fn is None:
            build_kernel()
            lib = ctypes.CDLL(str(library_path()))
            fn = lib.approx_topk_launch
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            # dot, its row stride, q_sq, c_sq, out d, out pos, B, n, M, k,
            # measure, stream
            fn.argtypes = [ptr, ctypes.c_longlong, ptr, ptr, ptr, ptr,
                           i32, i32, i32, i32, i32, ptr]
            fn.restype = ctypes.c_int
            _launch_fn = fn
    return _launch_fn


def _count() -> None:
    global launches
    with _count_lock:
        launches += 1


def shared_bytes(n: int, k: int) -> int:
    """Dynamic shared memory of a kernel block: the row's bin winners, a
    distance and a position each."""
    return 8 * _bins(n, k)


def bins_per_pass(n: int, k: int) -> int:
    """Bins a kernel thread holds in registers in one pass over the row, the
    kernel's template argument (``csrc/approx_topk.cu``): the least of 1, 2,
    4 and 8 that holds the thread's ``ceil(M / 128)`` bins, else 8 (more
    bins take passes)."""
    per_thread = -(-_bins(n, k) // 128)
    return next(rb for rb in (1, 2, 4, 8) if per_thread <= rb or rb == 8)


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
    if 8 * M > MAX_SHARED_BYTES:
        raise ValueError(f"approx top-k kernel: {M} bins (n={n}, k={k}) need "
                         f"{8 * M} B of shared memory a block, above "
                         f"{MAX_SHARED_BYTES}")
    q_sq, c_sq = q_sq.contiguous(), c_sq.contiguous()
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
    dot = q.to(torch.float32) @ c.to(torch.float32).T
    return approx_smallest_k(dot, q_sq, c_sq, k, measure)
