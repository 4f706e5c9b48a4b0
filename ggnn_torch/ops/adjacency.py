"""Fused anchor-block fetch + dequant dot (``csrc/adjacency_dot.cu``).

The quantized-adjacency walk's hot memory access (query/fused.py:
``_code_dists``): for every popped anchor, read its inline block of
neighbour codes and dot it with the (scale-multiplied) query row. On a CUDA
tensor :func:`adjacency_dot` launches the hand-written Hopper kernel; on a
CPU tensor it runs :func:`adjacency_dot_plain`, the gather + einsum version
that is also the kernel's oracle. There is no other route.

The kernel is compiled with ``nvcc`` at first use into ``build/kernels/``
under the repository root and bound through ctypes (a plain C entry point,
so the build takes seconds). The build is skipped while the shared library
is newer than its source.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = [
    "adjacency_dot",
    "adjacency_dot_plain",
    "build_kernel",
    "launches",
    "KERNEL_SOURCE",
]

KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "adjacency_dot.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_LIB_PATH = _BUILD_DIR / "adjacency_dot.so"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# kernel launches made by adjacency_dot (the plain CPU route does not count)
launches = 0

_lib = None
_lib_lock = threading.Lock()


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


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           f"{KERNEL_SOURCE.name}")
    return found


def build_kernel() -> float:
    """Compile the kernel's shared library unless it is newer than its
    source. Returns the seconds the build took (0.0 when skipped)."""
    if (_LIB_PATH.is_file()
            and _LIB_PATH.stat().st_mtime >= KERNEL_SOURCE.stat().st_mtime):
        return 0.0
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build beside the target and rename: concurrent builders never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(KERNEL_SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode:
            raise RuntimeError(
                f"nvcc failed on {KERNEL_SOURCE} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            build_kernel()
            lib = ctypes.CDLL(str(_LIB_PATH))
            fn = lib.adjacency_dot_launch
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


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


def adjacency_dot(qs: torch.Tensor, anchors: torch.Tensor,
                  blocks: torch.Tensor, *, nibbles: bool = False):
    """Fused fetch + dequant dot of the anchors' inline code blocks.

    Same contract as :func:`adjacency_dot_plain`, except that the lanes of a
    -1 anchor are left unwritten on the card. CPU tensors take the plain
    version; CUDA tensors launch the kernel, which needs contiguous inputs,
    ``D % 16 == 0`` and a 16-byte aligned ``blocks``.
    """
    global launches
    _check(qs, anchors, blocks)
    dev = qs.device
    if dev.type == "cpu":
        return adjacency_dot_plain(qs, anchors, blocks, nibbles=nibbles)
    if dev.type != "cuda":
        raise ValueError(f"adjacency_dot: unsupported device {dev}")
    B, D = qs.shape
    P = anchors.shape[1]
    N, CR, _ = blocks.shape
    if D % 16:
        raise ValueError(f"adjacency_dot kernel needs D % 16 == 0, got D={D}")
    if not (qs.is_contiguous() and anchors.is_contiguous()
            and blocks.is_contiguous()):
        raise ValueError("adjacency_dot kernel needs contiguous inputs")
    if blocks.data_ptr() % 16:
        raise ValueError("adjacency_dot kernel needs 16-byte aligned blocks")
    out = torch.empty((B, P, 2 * CR if nibbles else CR), dtype=torch.float32,
                      device=dev)
    if B == 0 or P == 0 or CR == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.adjacency_dot_launch(
            qs.data_ptr(), anchors.data_ptr(), blocks.data_ptr(),
            out.data_ptr(), B, P, CR, D, N, int(bool(nibbles)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"adjacency_dot kernel launch failed: CUDA error {err}")
    launches += 1
    return out
