"""The beam's sorted merge and the fused walk's cap cut as one Hopper kernel.

:func:`ggnn_torch.ops.beam.beam_insert` keeps, for each row, the first W
entries of the beam and the admitted candidates side by side in the order
of a stable ``torch.sort`` on distance; :func:`ggnn_torch.ops.beam.
cap_candidates` keeps the first ``cap`` admitted candidates in that order.
On CUDA tensors whose rows hold at most :data:`MAX_KEYS` keys (W + K) both
launch ``csrc/beam_sort.cu`` through :func:`merge`, bit-identical to the
``torch.sort`` route; wider rows take the ``torch.sort`` route on the card
(:func:`count_torch` counts it), and CPU tensors the plain code, which is
also the kernel's oracle. The route follows the shape alone
(:func:`route`).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ggnn_torch.utils import graphs, nvcc

__all__ = [
    "KERNEL",
    "MAX_KEYS",
    "TORCH",
    "build_kernel",
    "count_torch",
    "keys_per_lane",
    "kernel_resources",
    "library_path",
    "merge",
    "route",
    "rows_per_block",
]

KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "beam_sort.cu"
# the routes of a row's sort
KERNEL, TORCH = "kernel", "torch"
# keys (W + K) of a row the kernel takes at most
MAX_KEYS = 1024
# rows (one warp each) of a kernel block at most, and the shared memory a
# block aims under (``csrc/beam_sort.cu``: kMaxWarps, kSmemTarget)
MAX_ROWS_PER_BLOCK = 8
SMEM_TARGET = 48 * 1024

# launches of the kernel, and of the torch.sort route on the card (the
# plain CPU route counts in neither); updated under ``_count_lock``, and a
# launch captured into a CUDA graph counts once per replay of that graph
# (``graphs.count_launch``)
launches = 0
launches_torch = 0

_launch_fn = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def route(W: int, K: int) -> str:
    """How a row of a W-column beam and K candidates is sorted on the card:
    :data:`KERNEL` up to :data:`MAX_KEYS` keys, else :data:`TORCH`."""
    return KERNEL if W + K <= MAX_KEYS else TORCH


def keys_per_lane(W: int, K: int) -> int:
    """Keys a lane sorts in registers at most, the kernel's template
    argument: 2 up to 64 keys a row, else 8 (more than 256 admitted
    candidates are sorted in runs of 256)."""
    if route(W, K) != KERNEL:
        raise ValueError(f"beam sort kernel: W + K = {W + K} keys a row, "
                         f"above {MAX_KEYS}")
    return 2 if W + K <= 64 else 8


def rows_per_block(W: int, K: int) -> int:
    """Rows (one warp each) of a kernel block: ``MAX_ROWS_PER_BLOCK``,
    halved while the block's keys (8 bytes each, W + K a row) exceed
    ``SMEM_TARGET``."""
    r = MAX_ROWS_PER_BLOCK
    while r > 1 and r * 8 * (W + K) > SMEM_TARGET:
        r //= 2
    return r


def library_path() -> Path:
    """The kernel's shared library: named by the hash of its source and
    the nvcc flags, in the cache directory (``utils/nvcc.py``)."""
    return nvcc.library_path("beam_sort", KERNEL_SOURCE)


def build_kernel() -> float:
    """Compile the kernel's library unless the library of this source and
    these flags exists. Returns the seconds the build took (0.0 when it was
    there)."""
    return nvcc.build("beam_sort", KERNEL_SOURCE)


def kernel_resources():
    """Registers, shared and local (spill) bytes of the built kernels;
    None where ``cuobjdump`` is missing."""
    return nvcc.kernel_resources(library_path())


def _bind(path: Path):
    """The C entry point ``beam_sort_merge_launch`` of a built library."""
    fn = ctypes.CDLL(str(path)).beam_sort_merge_launch
    ptr, ld, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr, ld] * 5 + [ptr] * 5 + [i32] * 5 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def _load():
    global _launch_fn
    with _lib_lock:
        if _launch_fn is None:
            build_kernel()
            _launch_fn = _bind(library_path())
    return _launch_fn


def _count(kernel: bool) -> None:
    global launches, launches_torch
    with _count_lock:
        if kernel:
            launches += 1
        else:
            launches_torch += 1


def count_torch() -> None:
    """Count one sort of the ``torch.sort`` route on the card."""
    graphs.count_launch(_count, False)


def _call(device: torch.device, args) -> int:
    """Launch the kernel on ``device``'s current stream; its CUDA error
    code."""
    fn = _load()
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _rows(t: torch.Tensor, name: str, dtype: torch.dtype) -> int:
    """The row stride of a [B, n] tensor of ``dtype`` whose rows are
    contiguous (0 where one row is repeated)."""
    if t.dtype != dtype:
        raise ValueError(f"beam sort kernel: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"beam sort kernel: {name} must be [B, n] with "
                         f"contiguous rows, got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")
    return t.stride(0)


def _aligned(t: torch.Tensor, ld: int) -> bool:
    """Every row of ``t`` starts on a 16-byte boundary."""
    return t.data_ptr() % 16 == 0 and (ld * t.element_size()) % 16 == 0


def merge(cand_i: torch.Tensor, cand_d: torch.Tensor, criteria: torch.Tensor,
          width: int, *, beam=None, row_mask: torch.Tensor | None = None):
    """The kernel on CUDA tensors: the first ``width`` entries of each row
    of [beam, admitted candidates] in the stable ``torch.sort`` order.

    ``beam``: (d [B, W] f32, i [B, W] i32, exp [B, W] bool), its finite
    entries ascending and the rest +inf, or None (W = 0: the cap cut);
    ``cand_i`` [B, K] i32, ``cand_d`` [B, K] f32, ``criteria`` [B] f32: a
    candidate is admitted where its id is not -1 and its distance is below
    its row's criterion; ``row_mask`` [B] bool: rows where it is False keep
    the beam (``width`` == W). Rows of every [B, n] input are contiguous at
    any row stride. Returns (d, i, exp) of [B, width] with a beam, else
    (d, i)."""
    B, K = cand_i.shape
    W = 0 if beam is None else beam[0].shape[1]
    if not 0 <= width <= W + K:
        raise ValueError(f"beam sort kernel: width {width} outside 0..{W + K}")
    if route(W, K) != KERNEL:
        raise ValueError(f"beam sort kernel: W + K = {W + K} keys a row, "
                         f"above {MAX_KEYS}")
    if row_mask is not None and width != W:
        raise ValueError(f"beam sort kernel: a row mask keeps the beam, so "
                         f"the width must be W = {W}, got {width}")
    inputs = [(cand_d, "candidate distances", torch.float32),
              (cand_i, "candidate ids", torch.int32)]
    if beam is not None:
        inputs = [(beam[0], "beam distances", torch.float32),
                  (beam[1], "beam ids", torch.int32),
                  (beam[2], "beam flags", torch.bool)] + inputs
    ld = [_rows(t, name, dtype) for t, name, dtype in inputs]
    for t, name, _ in inputs:
        if tuple(t.shape) != (B, W if name.startswith("beam") else K):
            raise ValueError(f"beam sort kernel: {name} {tuple(t.shape)} "
                             f"against a beam of {W} and {K} candidates in "
                             f"{B} rows")
    if criteria.dtype != torch.float32 or tuple(criteria.shape) != (B,):
        raise ValueError(f"beam sort kernel: criteria must be [B] f32, got "
                         f"{tuple(criteria.shape)} {criteria.dtype}")
    if row_mask is not None and (row_mask.dtype != torch.bool
                                 or tuple(row_mask.shape) != (B,)):
        raise ValueError(f"beam sort kernel: row_mask must be [B] bool, got "
                         f"{tuple(row_mask.shape)} {row_mask.dtype}")
    dev = cand_i.device
    others = [t for t, _, _ in inputs] + [criteria]
    if row_mask is not None:
        others.append(row_mask)
    if {t.device for t in others} != {dev}:
        raise ValueError("beam sort kernel: inputs on several devices")
    d = torch.empty((B, width), dtype=torch.float32, device=dev)
    i = torch.empty((B, width), dtype=torch.int32, device=dev)
    exp = (None if beam is None
           else torch.empty((B, width), dtype=torch.bool, device=dev))
    out = (d, i) if beam is None else (d, i, exp)
    if B == 0 or width == 0:
        return out
    criteria = criteria.contiguous()
    row_mask = None if row_mask is None else row_mask.contiguous()
    vec = _aligned(cand_d, ld[-2]) and _aligned(cand_i, ld[-1])
    if beam is None:
        args = [None, 0] * 3
    else:
        args = [beam[0].data_ptr(), ld[0], beam[1].data_ptr(), ld[1],
                beam[2].data_ptr(), ld[2]]
    args += [cand_d.data_ptr(), ld[-2], cand_i.data_ptr(), ld[-1],
             criteria.data_ptr(),
             None if row_mask is None else row_mask.data_ptr(),
             d.data_ptr(), i.data_ptr(),
             None if exp is None else exp.data_ptr(),
             B, W, K, width, int(vec)]
    err = _call(dev, args)
    if err:
        raise RuntimeError(f"beam sort kernel launch failed: CUDA error {err}")
    graphs.count_launch(_count, True)
    return out
