"""On-demand compilation of the native host runtime (g++ -> shared library).

``src/ggnn_native.cpp`` compiles at first use into the port's library
cache (``ggnn_torch/utils/cache.py``: ``build/kernels/`` or
``$GGNN_TORCH_CACHE``), named by the hash of the source and the g++ flags,
built beside its target and renamed into place, and is bound with ctypes.
Where g++ is missing or fails, or ``GGNN_TORCH_NO_NATIVE`` is set, ``load``
returns None and the callers take their numpy routes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

from ggnn_torch.utils.cache import keyed_library
from ggnn_torch.utils.logging import vlog

__all__ = ["SOURCE", "library_path", "load"]

SOURCE = Path(__file__).resolve().parent / "src" / "ggnn_native.cpp"
_FLAGS = ("-O3", "-std=c++20", "-shared", "-fPIC", "-pthread")

_lib = None
_tried = False
_lock = threading.Lock()


def library_path() -> Path:
    return keyed_library("ggnn_native", SOURCE, _FLAGS)


def _build(target: Path) -> bool:
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            vlog(0, "native runtime: g++ failed (%d): %s", proc.returncode,
                 proc.stderr[-2000:])
            return False
        os.replace(tmp, target)
        return True
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL | None:
    """The native library, built if needed; None where it cannot be."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GGNN_TORCH_NO_NATIVE"):
            return None
        path = library_path()
        try:
            if not path.is_file() and not _build(path):
                return None
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError) as e:
            vlog(0, "native runtime unavailable: %s", e)
            return None

        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.ggnn_vecs_info.restype = i64
        lib.ggnn_vecs_info.argtypes = [ctypes.c_char_p, i64, ctypes.POINTER(i64)]
        lib.ggnn_read_vecs.restype = i64
        lib.ggnn_read_vecs.argtypes = [ctypes.c_char_p, i64, i64, i64, ptr]
        lib.ggnn_write_vecs.restype = i64
        lib.ggnn_write_vecs.argtypes = [ctypes.c_char_p, ptr, i64, i64, i64]
        lib.ggnn_merge_topk.restype = None
        lib.ggnn_merge_topk.argtypes = [ptr, ptr, i64, i64, i64, i64, i64, ptr,
                                        ptr, i64]
        _lib = lib
        return _lib
