"""ctypes bindings of the native TEXMEX reader and writer
(``src/ggnn_native.cpp``: ``ggnn_vecs_info``, ``ggnn_read_vecs``,
``ggnn_write_vecs``; the reference's blocked loader, dataset.cu:118-233)."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ggnn_torch.native.build import load

__all__ = ["available", "load_vecs", "store_vecs"]


def available() -> bool:
    return load() is not None


def load_vecs(path: str | os.PathLike, dtype, from_row: int = 0,
              num: int | None = None) -> np.ndarray:
    """Rows ``from_row`` to ``from_row + num`` of a TEXMEX file as an
    ``[n, D]`` array of ``dtype`` (headers stripped)."""
    lib = load()
    dtype = np.dtype(dtype)
    name = os.fsencode(path)
    dim = ctypes.c_int64(0)
    total = lib.ggnn_vecs_info(name, dtype.itemsize, ctypes.byref(dim))
    if total < 0:
        raise ValueError(f"{path}: not a valid TEXMEX file")
    if from_row >= total:
        raise ValueError(f"{path}: from={from_row} beyond {total} rows")
    n = total - from_row if num is None else min(num, total - from_row)
    out = np.empty((n, dim.value), dtype=dtype)
    got = lib.ggnn_read_vecs(name, dtype.itemsize, from_row, n,
                             out.ctypes.data_as(ctypes.c_void_p))
    if got != n:
        raise ValueError(f"{path}: read {got} of {n} rows (a row's dimension "
                         "header differs, or the file is short)")
    return out


def store_vecs(path: str | os.PathLike, data: np.ndarray) -> None:
    """Write an ``[n, D]`` array as TEXMEX rows."""
    lib = load()
    data = np.ascontiguousarray(data)
    if data.ndim != 2:
        raise ValueError("expected a 2-D array")
    n, d = data.shape
    got = lib.ggnn_write_vecs(os.fsencode(path),
                              data.ctypes.data_as(ctypes.c_void_p), n, d,
                              data.itemsize)
    if got != n:
        raise OSError(f"{path}: wrote {got} of {n} rows")
