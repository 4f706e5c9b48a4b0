"""Building and inspecting the port's CUDA kernels.

Every kernel source under ``ggnn_torch/csrc/`` is compiled the same way:
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface, at
first use, bound through ctypes. The library is named by a hash of the
source and these flags (``utils/cache.py:keyed_library``), so a library
built from another source, or with other flags, is never loaded. Each C
entry point takes the caller's stream and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from ggnn_torch.utils.cache import keyed_library

__all__ = [
    "FLAGS",
    "build",
    "compile_library",
    "count_opcodes",
    "kernel_resources",
    "library_path",
    "nvcc",
    "parse_res_usage",
]

FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s,
    else the one on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the port's kernels")
    return found


def compile_library(source: Path, target: Path) -> float:
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
            [nvcc(), *FLAGS, "-o", tmp, str(source)],
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


def library_path(stem: str, source: Path) -> Path:
    """The shared library of ``source``: ``<stem>_<hash>.so`` of its bytes
    and the nvcc flags, in the cache directory."""
    return keyed_library(stem, source, FLAGS)


def build(stem: str, source: Path) -> float:
    """Compile ``source`` unless the library of this source and these flags
    exists. Returns the seconds the build took (0.0 when it was there)."""
    target = library_path(stem, source)
    if target.is_file():
        return 0.0
    return compile_library(source, target)


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


def kernel_resources(lib_path: Path):
    """Registers, shared and local (spill) bytes of each kernel in a built
    library and its count of int -> float conversions (``I2F*``) in the
    SASS, read with the ``cuobjdump`` beside ``nvcc``; None where that tool
    is missing."""
    try:
        tool = Path(nvcc()).parent / "cuobjdump"
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
