"""The walks' fused gather + distance: candidate base rows dotted with each
row's query vector(s) and finished into distances.

The JAX package gathers a walk step's candidate rows and feeds them to an
``einsum`` at ``Precision.HIGHEST``; XLA fuses the two inside the walks'
``lax.while_loop`` (``ggnn_tpu/ops/traverse.py:33`` ``gather_dists``,
``ggnn_tpu/build/sym.py:55`` ``_pair_dists`` with its gather at :176, and
the fused query's exact re-rank, ``ggnn_tpu/query/fused.py:782``). This
module is that computation. For ``qs [B, Q, D]`` f32 (``Q`` of 1 or 2
query vectors a row: the sym walk's node and half-way point), their squared
norms ``q_sq [B, Q]``, layer-local ``ids [B, K]`` (-1 allowed), an optional
``translation [N_l]`` to base ids, ``base [N, D]`` f32 or uint8 and
``base_sq [N]``::

    t[b, k]    = translation[max(ids[b, k], 0)]   (max(ids[b, k], 0) without)
    d[b, j, k] = finish(sum_d qs[b, j, d] * f32(base[t[b, k], d]),
                        q_sq[b, j], base_sq[t[b, k]])

and returns ``(d [B, Q, K] f32, t [B, K] int64)``, or ``(d, None)`` when
the caller asks for no base ids (``with_ids=False``: the walks, which
discard them, so the kernel writes none). An id of -1 is read as 0, so
every entry is defined; callers mask those columns. An id past the layer
raises on either route (the kernel by a device assert, reported at the
next synchronisation).

:func:`gather_dist` launches the hand-written Hopper kernel
``csrc/gather_dist.cu`` on CUDA tensors (a warp a row, each candidate row
read once with 16-byte loads, the queries in registers, ``finish`` in its
f32 order) and runs :func:`gather_dist_plain` -- the gather, the ``einsum``
and ``finish``, as the walks ran them before -- on CPU tensors. There is no
other route: a failed build or launch raises. The kernel sums the dot in
its own order, not cuBLAS's: it agrees with the plain version within the
rounding of a sum of D products (``|d - d_plain| <= D * 2**-23 * (q_sq +
c_sq)``, cosine ``D * 2**-22``), and its base ids are equal.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ggnn_torch.config import DistanceMeasure
from ggnn_torch.ops.distance import dist_gathered
from ggnn_torch.utils import graphs, nvcc

__all__ = [
    "build_kernel",
    "error_bound",
    "gather_dist",
    "gather_dist_plain",
    "kernel_resources",
    "library_path",
    "variant",
    "variant_launches",
]

KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "gather_dist.cu"

# launches of the kernel (the plain CPU route does not count), updated under
# ``_count_lock``; a launch captured into a CUDA graph counts once per replay
# (``graphs.count_launch``)
launches = 0
# the same launches by kernel variant (:func:`variant`)
launches_by_variant: dict = {}

_launch_fn = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _translated(ids, translation):
    """Base ids ``[B, K]`` int64 of layer-local ``ids`` (-1 read as 0)."""
    safe = ids.clamp_min(0).long()
    if translation is not None and translation.shape[0]:
        return translation[safe].long()
    return safe


def gather_dist_plain(qs, q_sq, ids, base, base_sq, translation=None,
                      measure=DistanceMeasure.Euclidean, with_ids=True):
    """The plain version of the kernel (module docstring): the ``[B, K, D]``
    gather, an ``einsum`` per query vector and ``finish``."""
    base_ids = _translated(ids, translation)
    vecs = base[base_ids]  # [B, K, D]
    cand_sq = base_sq[base_ids]
    # one contiguous query vector an einsum: the CPU's sums as before the
    # kernel, bit for bit
    d = torch.stack([dist_gathered(qs[:, j].contiguous(), vecs, measure,
                                   q_sq=q_sq[:, j], cand_sq=cand_sq)
                     for j in range(qs.shape[1])], dim=1)
    return d, base_ids if with_ids else None


def error_bound(q_sq, c_sq, D, measure=DistanceMeasure.Euclidean):
    """The most the kernel's distances may differ from the plain version's,
    ``[B, Q, K]`` from ``q_sq [B, Q]`` and the candidates' norms ``c_sq [B,
    K]``: the rounding of two sums of ``D`` f32 products in different
    orders, ``D * 2**-23 * (q_sq + c_sq)`` (Euclidean, whose ``2 * dot``
    doubles it) or ``D * 2**-22`` (cosine, the dot over the norms)."""
    if DistanceMeasure(measure) == DistanceMeasure.Euclidean:
        return D * 2.0 ** -23 * (q_sq[:, :, None] + c_sq[:, None, :])
    return torch.full((q_sq.shape[0], q_sq.shape[1], c_sq.shape[1]),
                      D * 2.0 ** -22, device=q_sq.device)


def library_path() -> Path:
    """The kernel's shared library: named by the hash of its source and
    the nvcc flags, in the cache directory (``utils/nvcc.py``)."""
    return nvcc.library_path("gather_dist", KERNEL_SOURCE)


def build_kernel() -> float:
    """Compile the kernel's library unless the library of this source and
    these flags exists. Returns the seconds the build took (0.0 when it was
    there)."""
    return nvcc.build("gather_dist", KERNEL_SOURCE)


def kernel_resources():
    """Registers, shared and local (spill) bytes of the built kernels;
    None where ``cuobjdump`` is missing."""
    return nvcc.kernel_resources(library_path())


def _bind(lib_path):
    """The C entry point ``gather_dist_launch`` of a built library (this
    tree's, or another build of the same interface: ``gather_bench.py``)."""
    fn = ctypes.CDLL(str(lib_path)).gather_dist_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # qs, its strides, q_sq, ids, translation, base, its row stride, u8,
    # base_sq, out d, out ids, B, Q, K, D, ids' range, base rows, measure,
    # stream
    fn.argtypes = [ptr, i64, i64, ptr, ptr, ptr, ptr, i64, i32, ptr, ptr, ptr,
                   i32, i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def _load():
    global _launch_fn
    with _lib_lock:
        if _launch_fn is None:
            build_kernel()
            _launch_fn = _bind(library_path())
    return _launch_fn


def variant(Q: int, D: int, u8: bool) -> tuple[int, int, bool]:
    """The kernel instance a launch takes: (Q, NS, u8), ``NS`` the 128-wide
    slabs of query values a lane keeps in registers -- 1 up to D = 128,
    else 4, the rest of the row in passes (``csrc/gather_dist.cu``:
    ``gather_dist_kernel<Q, NS, u8, vec>``)."""
    return (int(Q), 1 if D <= 128 else 4, bool(u8))


def variant_launches() -> dict:
    """Kernel launches by :func:`variant` since import (a launch in a CUDA
    graph once per replay); beside ``graphs.stats()``."""
    with _count_lock:
        return dict(launches_by_variant)


def _count(key: tuple) -> None:
    global launches
    with _count_lock:
        launches += 1
        launches_by_variant[key] = launches_by_variant.get(key, 0) + 1


def _launch(qs, q_sq, ids, base, base_sq, translation, measure, with_ids):
    B, Q, D = qs.shape
    K = ids.shape[1]
    for t, name in ((qs, "qs"), (q_sq, "q_sq"), (base_sq, "base_sq")):
        if t.dtype != torch.float32:
            raise ValueError(f"gather_dist kernel: {name} must be float32, got "
                             f"{t.dtype}")
    if base.dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"gather_dist kernel: base must be float32 or uint8, "
                         f"got {base.dtype}")
    if D > 1 and (qs.stride(2) != 1 or base.stride(1) != 1):
        raise ValueError("gather_dist kernel: the rows of qs and base must have "
                         f"contiguous elements, got strides {qs.stride()}, "
                         f"{base.stride()}")
    q_sq = q_sq.contiguous()
    ids = ids.to(torch.int32).contiguous()
    base_sq = base_sq.contiguous()
    if translation is not None and translation.shape[0]:
        translation = translation.to(torch.int32).contiguous()
    else:
        translation = None
    n_base = base.shape[0]
    n_ids = translation.shape[0] if translation is not None else n_base
    out_d = torch.empty((B, Q, K), dtype=torch.float32, device=qs.device)
    out_ids = (torch.empty((B, K), dtype=torch.int64, device=qs.device)
               if with_ids else None)
    if B == 0 or K == 0:
        return out_d, out_ids
    fn = _load()
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        err = fn(qs.data_ptr(), qs.stride(0), qs.stride(1), q_sq.data_ptr(),
                 ids.data_ptr(),
                 translation.data_ptr() if translation is not None else None,
                 base.data_ptr(), base.stride(0), int(base.dtype == torch.uint8),
                 base_sq.data_ptr(), out_d.data_ptr(),
                 out_ids.data_ptr() if with_ids else None, B, Q, K, D, n_ids,
                 n_base, int(measure), stream)
    if err:
        raise RuntimeError(f"gather_dist kernel launch failed: CUDA error {err}")
    graphs.count_launch(_count, variant(Q, D, base.dtype == torch.uint8))
    return out_d, out_ids


def gather_dist(qs: torch.Tensor, q_sq: torch.Tensor, ids: torch.Tensor,
                base: torch.Tensor, base_sq: torch.Tensor,
                translation: torch.Tensor | None = None,
                measure: DistanceMeasure = DistanceMeasure.Euclidean,
                with_ids: bool = True):
    """Distances from each row's ``Q`` query vectors to its candidates
    (module docstring): ``qs [B, Q, D]`` f32 (Q = 1 or 2), ``q_sq [B, Q]``,
    ``ids [B, K]`` layer-local (-1 read as 0), ``translation [N_l]`` or
    None (an empty one counts as None), ``base [N, D]`` f32 or uint8,
    ``base_sq [N]``. Returns ``(d [B, Q, K] f32, base_ids [B, K] int64)``;
    ``base_ids`` is None with ``with_ids=False`` (nor does the kernel write
    them).
    CPU tensors take :func:`gather_dist_plain`; CUDA tensors launch the
    kernel; another device raises."""
    measure = DistanceMeasure(measure)
    if qs.dim() != 3 or qs.shape[1] not in (1, 2):
        raise ValueError(f"gather_dist: qs must be [B, Q, D] with Q of 1 or 2, "
                         f"got {tuple(qs.shape)}")
    B, Q, D = qs.shape
    if (q_sq.shape != (B, Q) or ids.dim() != 2 or ids.shape[0] != B
            or base.dim() != 2 or base.shape[1] != D
            or base_sq.shape != (base.shape[0],)):
        raise ValueError(f"gather_dist: shapes qs {tuple(qs.shape)}, q_sq "
                         f"{tuple(q_sq.shape)}, ids {tuple(ids.shape)}, base "
                         f"{tuple(base.shape)}, base_sq {tuple(base_sq.shape)}")
    dev = qs.device
    if dev.type == "cpu":
        return gather_dist_plain(qs, q_sq, ids, base, base_sq, translation,
                                 measure, with_ids)
    if dev.type != "cuda":
        raise ValueError(f"gather_dist: unsupported device {dev}")
    return _launch(qs, q_sq, ids, base, base_sq, translation, measure,
                   with_ids)
