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
import re
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
    "kernel_resources",
    "launches",
    "launches_nibbles",
    "KERNEL_SOURCE",
]

KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "adjacency_dot.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_LIB_PATH = _BUILD_DIR / "adjacency_dot.so"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# kernel launches made by adjacency_dot (the plain CPU route does not count):
# all of them, and those in int4 ``nibbles`` mode
launches = 0
launches_nibbles = 0

_launch_fn = None
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


def _compile(source: Path, target: Path) -> float:
    """Compile ``source`` into the shared library ``target``. Returns the
    seconds it took."""
    target.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build beside the target and rename: concurrent builders never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode:
            raise RuntimeError(
                f"nvcc failed on {source} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0


def build_kernel() -> float:
    """Compile the kernel's shared library unless it is newer than its
    source. Returns the seconds the build took (0.0 when skipped)."""
    if (_LIB_PATH.is_file()
            and _LIB_PATH.stat().st_mtime >= KERNEL_SOURCE.stat().st_mtime):
        return 0.0
    return _compile(KERNEL_SOURCE, _LIB_PATH)


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
            _launch_fn = _bind(_LIB_PATH)
    return _launch_fn


def parse_res_usage(text: str) -> dict:
    """``cuobjdump -res-usage`` output -> {kernel: {"REG": n, "SHARED": n,
    "LOCAL": n, ...}} (LOCAL: local memory per thread, where spills go)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s+(\S+?):?\s*$", line)
        if m:
            name = m.group(1)
        elif name is not None and "REG:" in line:
            out[name] = {k: int(v) for k, v in
                         re.findall(r"([A-Z_]+(?:\[\d+\])?):(\d+)", line)}
            name = None
    return out


def count_opcodes(sass: str, prefix: str) -> dict:
    """SASS instructions (``cuobjdump -sass``) whose opcode starts with
    ``prefix``, per kernel."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            out[name] = 0
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and name is not None and m.group(1).startswith(prefix):
            out[name] += 1
    return out


def kernel_resources(lib_path: Path = _LIB_PATH):
    """Registers, shared and local (spill) bytes of each kernel in a built
    library and its count of int -> float conversions (``I2F*``) in the
    SASS, read with the ``cuobjdump`` beside ``nvcc``; None where that tool
    is missing."""
    try:
        tool = Path(_nvcc()).parent / "cuobjdump"
    except RuntimeError:
        return None
    if not tool.is_file():
        return None

    def run(flag):
        return subprocess.run([str(tool), flag, str(lib_path)], capture_output=True,
                              text=True, check=True).stdout

    kernels = parse_res_usage(run("-res-usage"))
    for name, n in count_opcodes(run("-sass"), "I2F").items():
        kernels.setdefault(name, {})["I2F"] = n
    return kernels


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
    """What the kernel needs beyond :func:`_check`."""
    if qs.shape[1] % 16:
        raise ValueError(f"adjacency_dot kernel needs D % 16 == 0, got D={qs.shape[1]}")
    if not (qs.is_contiguous() and anchors.is_contiguous()
            and blocks.is_contiguous()):
        raise ValueError("adjacency_dot kernel needs contiguous inputs")
    if qs.data_ptr() % 16 or blocks.data_ptr() % 16:
        raise ValueError("adjacency_dot kernel needs 16-byte aligned qs and blocks")


def adjacency_dot(qs: torch.Tensor, anchors: torch.Tensor,
                  blocks: torch.Tensor, *, nibbles: bool = False):
    """Fused fetch + dequant dot of the anchors' inline code blocks.

    Same contract as :func:`adjacency_dot_plain`, except that the lanes of a
    -1 anchor are left unwritten on the card. CPU tensors take the plain
    version; CUDA tensors launch the kernel, which needs contiguous inputs,
    ``D % 16 == 0`` and 16-byte aligned ``qs`` and ``blocks``.
    """
    global launches, launches_nibbles
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
    launches += 1
    launches_nibbles += bool(nibbles)
    return out
