"""Fused anchor-block fetch + dequant dot (``csrc/adjacency_dot.cu``).

The quantized-adjacency walk's hot memory access (query/fused.py:
``_code_dists``): for every popped anchor, read its inline block of
neighbour codes and dot it with the (scale-multiplied) query row. On a CUDA
tensor :func:`adjacency_dot` launches the hand-written Hopper kernel; on a
CPU tensor it runs :func:`adjacency_dot_plain`, the gather + einsum version
that is also the kernel's oracle. There is no other route.

The kernel is compiled with ``nvcc`` at first use and bound through ctypes
(a plain C entry point, so the build takes seconds; ``utils/nvcc.py``). The
library is named by a hash of the source and the nvcc flags, in
``build/kernels/`` under the repository root or in ``$GGNN_TORCH_CACHE``
(``ggnn_torch/utils/cache.py``): a library built from another source is
never loaded.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ggnn_torch.utils import graphs, nvcc

__all__ = [
    "adjacency_dot",
    "adjacency_dot_plain",
    "build_kernel",
    "count_fetched",
    "fetched_anchors",
    "kernel_resources",
    "library_path",
    "launches",
    "launches_nibbles",
    "variant",
    "variant_launches",
    "KERNEL_SOURCE",
]

KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "adjacency_dot.cu"
# the shared build (``utils/nvcc.py``), under the names this module had
_compile = nvcc.compile_library
parse_res_usage = nvcc.parse_res_usage
count_opcodes = nvcc.count_opcodes

# kernel launches made by adjacency_dot (the plain CPU route does not count):
# all of them, and those in int4 ``nibbles`` mode; updated under
# ``_count_lock`` (build workers launch from several threads). A launch
# captured into a CUDA graph counts once per replay of that graph
# (``graphs.count_launch``), not at its capture.
launches = 0
launches_nibbles = 0
# the same launches by kernel variant (:func:`variant`)
launches_by_variant: dict = {}
# anchors the walks fetched while a profiler recorded (:func:`count_fetched`),
# by variant: device scalars, read by :func:`fetched_anchors`
_fetched: dict = {}

_launch_fn = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def adjacency_dot_plain(qs: torch.Tensor, anchors: torch.Tensor,
                        blocks: torch.Tensor, *, nibbles: bool = False):
    """Gather + einsum: the plain version of the kernel.

    qs: [B, D] f32 -- query rows, already multiplied by the dequant scale;
    anchors: [B, P] i32 (-1 allowed; callers mask those lanes);
    blocks: [N, CR, D] u8 inline neighbour codes (with ``nibbles`` each code
    row holds two neighbours' int4 codes, low nibble first).
    Returns dots [B, P, K] f32 (K = CR, or 2*CR ordered [all low | all high])
    of the bf16-rounded query rows against the raw codes.
    """
    craw = blocks[anchors.clamp_min(0).long()]  # [B, P, CR, D] u8
    if nibbles:
        craw = torch.cat([craw & 15, craw >> 4], dim=2)
    q = qs.to(torch.bfloat16).to(torch.float32)
    return torch.einsum("bd,bpkd->bpk", q, craw.to(torch.float32))


def library_path(source: Path = KERNEL_SOURCE) -> Path:
    """The shared library of ``source``: named by the hash of its bytes and
    the nvcc flags, in the cache directory."""
    return nvcc.library_path("adjacency_dot", source)


def build_kernel() -> float:
    """Compile the kernel's shared library unless the library of this
    source and these flags exists. Returns the seconds the build took (0.0
    when it was there)."""
    return nvcc.build("adjacency_dot", KERNEL_SOURCE)


def _bind(path: Path):
    """The C entry point ``adjacency_dot_launch`` of a built library."""
    fn = ctypes.CDLL(str(path)).adjacency_dot_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _load():
    global _launch_fn
    with _lib_lock:
        if _launch_fn is None:
            build_kernel()
            _launch_fn = _bind(library_path())
    return _launch_fn


def kernel_resources(lib_path: Path | None = None):
    """Registers, shared and local (spill) bytes of each kernel in a built
    library (by default this source's) and its count of int -> float
    conversions (``I2F*``) in the SASS; None where ``cuobjdump`` is
    missing."""
    return nvcc.kernel_resources(library_path() if lib_path is None else lib_path)


def variant(D: int, nibbles: bool = False) -> tuple[str, int, bool]:
    """The kernel a launch of code rows ``D`` bytes wide takes: (layout,
    lanes a code row, wide). Where D % 16 == 0 the layout is "u8" or
    "int4" and lanes cover the row's D/16 16-byte chunks, a power of two of
    at most 32; above 32 chunks (D > 512) the "wide" kernel loops over a
    lane's chunks (``csrc/adjacency_dot.cu``: ``adjacency_dot_<layout>_t<lanes>``
    or ``adjacency_dot_<layout>_wide``). Other widths take the tail
    kernels, layout "u8_tail" or "int4_tail": their chunks are the row's
    D/4 4-byte words (wide above 32 words, D > 128). Only a name: the
    kernel route refuses D % 4 != 0 (:func:`_check_kernel_inputs`)."""
    tail = D % 16 != 0
    chunks = D // 4 if tail else D // 16
    lanes = min(32, 1 << max(0, chunks - 1).bit_length())
    layout = "int4" if nibbles else "u8"
    return (layout + "_tail" if tail else layout, lanes, chunks > 32)


def variant_launches() -> dict:
    """Kernel launches by :func:`variant` since import (a launch in a CUDA
    graph once per replay); beside ``graphs.stats()``."""
    with _count_lock:
        return dict(launches_by_variant)


def count_fetched(key: tuple, n: torch.Tensor) -> None:
    """Add ``n`` (a device scalar: anchors >= 0 handed to the kernel) to the
    anchors fetched at variant ``key``. The walks call it outside their steps
    and only while a profiler records (``utils/spans.py:recording``), so
    that a roofline can count the bytes the traced launches read."""
    with _count_lock:
        _fetched[key] = _fetched.get(key, 0) + n


def fetched_anchors() -> dict:
    """Anchors fetched by variant, counted by :func:`count_fetched` since
    import (reads the device)."""
    with _count_lock:
        return {k: int(v) for k, v in _fetched.items()}


def _check(qs, anchors, blocks):
    if not (qs.device == anchors.device == blocks.device):
        raise ValueError("qs, anchors and blocks must be on one device: "
                         f"{qs.device}, {anchors.device}, {blocks.device}")
    if qs.dtype != torch.float32 or qs.dim() != 2:
        raise ValueError(f"qs must be [B, D] float32, got {qs.dtype} {tuple(qs.shape)}")
    if anchors.dtype != torch.int32 or anchors.dim() != 2:
        raise ValueError("anchors must be [B, P] int32, got "
                         f"{anchors.dtype} {tuple(anchors.shape)}")
    if blocks.dtype != torch.uint8 or blocks.dim() != 3:
        raise ValueError("blocks must be [N, CR, D] uint8, got "
                         f"{blocks.dtype} {tuple(blocks.shape)}")
    if anchors.shape[0] != qs.shape[0] or blocks.shape[2] != qs.shape[1]:
        raise ValueError(f"shape mismatch: qs {tuple(qs.shape)}, anchors "
                         f"{tuple(anchors.shape)}, blocks {tuple(blocks.shape)}")


def _check_kernel_inputs(qs, anchors, blocks):
    """What the kernel needs beyond :func:`_check`: D % 4 == 0, contiguous
    inputs, ``qs`` 16-byte aligned, and ``blocks`` aligned to its loads --
    16 bytes where D % 16 == 0, else 4 (the tail kernels' code rows start
    every D bytes, so 4-byte aligned at best)."""
    D = qs.shape[1]
    if D % 4:
        raise ValueError(f"adjacency_dot kernel needs D % 4 == 0 (4-byte aligned "
                         f"code rows), got D={D}")
    if not (qs.is_contiguous() and anchors.is_contiguous()
            and blocks.is_contiguous()):
        raise ValueError("adjacency_dot kernel needs contiguous inputs")
    if qs.data_ptr() % 16:
        raise ValueError("adjacency_dot kernel needs 16-byte aligned qs")
    align = 4 if D % 16 else 16
    if blocks.data_ptr() % align:
        raise ValueError(f"adjacency_dot kernel needs {align}-byte aligned "
                         f"blocks at D={D}")


def adjacency_dot(qs: torch.Tensor, anchors: torch.Tensor,
                  blocks: torch.Tensor, *, nibbles: bool = False):
    """Fused fetch + dequant dot of the anchors' inline code blocks.

    Same contract as :func:`adjacency_dot_plain`, except that the lanes of a
    -1 anchor are left unwritten on the card. CPU tensors take the plain
    version; CUDA tensors launch the kernel, which needs contiguous inputs,
    ``D % 4 == 0`` (4-byte aligned code rows; rows of D % 16 != 0 bytes
    take the tail kernels, :func:`variant`), 16-byte aligned ``qs`` and
    ``blocks`` aligned to 16 bytes where D % 16 == 0, else to 4.
    """
    _check(qs, anchors, blocks)
    dev = qs.device
    if dev.type == "cpu":
        return adjacency_dot_plain(qs, anchors, blocks, nibbles=nibbles)
    if dev.type != "cuda":
        raise ValueError(f"adjacency_dot: unsupported device {dev}")
    _check_kernel_inputs(qs, anchors, blocks)
    B, D = qs.shape
    P = anchors.shape[1]
    N, CR, _ = blocks.shape
    out = torch.empty((B, P, 2 * CR if nibbles else CR), dtype=torch.float32,
                      device=dev)
    if B == 0 or P == 0 or CR == 0:
        return out
    fn = _load()
    with torch.cuda.device(dev):
        err = fn(qs.data_ptr(), anchors.data_ptr(), blocks.data_ptr(),
                 out.data_ptr(), B, P, CR, D, N, int(bool(nibbles)),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"adjacency_dot kernel launch failed: CUDA error {err}")
    graphs.count_launch(_count, bool(nibbles), variant(D, nibbles))
    return out


def _count(nibbles: bool, key: tuple) -> None:
    global launches, launches_nibbles
    with _count_lock:
        launches += 1
        launches_nibbles += nibbles
        launches_by_variant[key] = launches_by_variant.get(key, 0) + 1
