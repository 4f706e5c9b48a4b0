"""ctypes binding of the native multi-threaded k-way result merger
(``src/ggnn_native.cpp``: ``ggnn_merge_topk``; the reference's
result_merger.cpp:79-148)."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ggnn_torch.native.build import load

__all__ = ["available", "merge_topk_partials"]


def available() -> bool:
    return load() is not None


def merge_topk_partials(ids: np.ndarray, dists: np.ndarray, k_out: int,
                        id_offset_scale: int = 0,
                        num_threads: int | None = None):
    """Merge per-partition results whose rows are sorted by distance.

    ids: [parts, Q, stride] int32; dists: the same shape, float32;
    ``id_offset_scale``: partition ``p``'s ids gain ``p * scale`` (0 when
    they are global already). Among equal distances the lower partition
    comes first (a stable sort of the partitions' rows in partition order);
    past a partition's ``stride`` entries it yields -1 at +inf.

    Returns (ids [Q, k_out] int32, dists [Q, k_out] float32).
    """
    lib = load()
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    dists = np.ascontiguousarray(dists, dtype=np.float32)
    if ids.ndim != 3 or ids.shape != dists.shape:
        raise ValueError(f"ids {ids.shape} and dists {dists.shape} must be one "
                         "[parts, Q, stride] shape")
    num_parts, num_queries, stride = ids.shape
    if num_parts < 1 or stride < 1 or k_out < 1:
        raise ValueError(f"empty merge: parts {num_parts}, stride {stride}, "
                         f"k_out {k_out}")
    out_ids = np.empty((num_queries, k_out), np.int32)
    out_dists = np.empty((num_queries, k_out), np.float32)
    if num_threads is None:
        num_threads = min(os.cpu_count() or 1, 16)
    lib.ggnn_merge_topk(
        ids.ctypes.data_as(ctypes.c_void_p),
        dists.ctypes.data_as(ctypes.c_void_p),
        num_parts, num_queries, stride, k_out, id_offset_scale,
        out_ids.ctypes.data_as(ctypes.c_void_p),
        out_dists.ctypes.data_as(ctypes.c_void_p),
        num_threads,
    )
    return out_ids, out_dists
