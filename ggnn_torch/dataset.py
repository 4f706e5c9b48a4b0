"""Datasets and binary vector-file IO (host side, numpy).

Equivalent of the reference's ``GenericDataset``/``Dataset<T>``
(include/ggnn/base/dataset.cuh:38-166, src/ggnn/base/dataset.cu:118-233).
Data stays on the host; ``GGNN`` moves each shard to its device.

Supported on-disk formats:
  * ``.fvecs`` / ``.bvecs`` / ``.ivecs``  (TEXMEX: per-row int32 dim header)
  * ``.hdf5`` / ``.h5``  (ANN-benchmarks layout: train/test/neighbors/distances)
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

__all__ = [
    "Dataset",
    "FloatDataset",
    "UCharDataset",
    "IntDataset",
    "load_fvecs",
    "load_bvecs",
    "load_ivecs",
    "store_fvecs",
    "store_bvecs",
    "store_ivecs",
    "load_vecs",
    "store_vecs",
    "load_hdf5_dataset",
]

_VECS_DTYPES = {
    ".fvecs": np.float32,
    ".bvecs": np.uint8,
    ".ivecs": np.int32,
}


def _vecs_dtype(path: Path):
    dtype = _VECS_DTYPES.get(path.suffix)
    if dtype is None:
        raise ValueError(f"unsupported vector file extension: {path.suffix}")
    return dtype


def load_vecs(path: str | os.PathLike, from_row: int = 0,
              num: int | None = None) -> np.ndarray:
    """Load a TEXMEX ``.{f,b,i}vecs`` file as an ``[N, D]`` array, rows
    ``from_row`` to ``from_row + num`` (dataset.cu:118-202; the bindings'
    ``from``/``num``, nanobind.cu:163-164)."""
    path = Path(path)
    dtype = _vecs_dtype(path)
    itemsize = np.dtype(dtype).itemsize
    file_size = path.stat().st_size
    with open(path, "rb") as f:
        dim_header = np.fromfile(f, dtype=np.int32, count=1)
    if dim_header.size != 1:
        raise ValueError(f"{path}: cannot read dimension header")
    D = int(dim_header[0])
    if D <= 0:
        raise ValueError(f"{path}: invalid dimension {D}")
    row_bytes = 4 + D * itemsize
    if file_size % row_bytes:
        raise ValueError(
            f"{path}: file size {file_size} is not a multiple of row size {row_bytes}")
    n_total = file_size // row_bytes
    if from_row >= n_total:
        raise ValueError(f"{path}: from={from_row} beyond {n_total} rows")
    n = n_total - from_row if num is None else min(num, n_total - from_row)
    # memory-map, strip the per-row dim headers
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    raw = raw[from_row * row_bytes : (from_row + n) * row_bytes].reshape(n, row_bytes)
    hdr = raw[: min(n, 4), :4].copy().view(np.int32).ravel()
    if not np.all(hdr == D):
        raise ValueError(f"{path}: inconsistent row dimension headers")
    return np.ascontiguousarray(raw[:, 4:]).view(dtype).reshape(n, D)


def store_vecs(path: str | os.PathLike, data) -> None:
    """Store an ``[N, D]`` array in TEXMEX format (dataset.cu:223-233)."""
    path = Path(path)
    data = np.ascontiguousarray(data, dtype=_vecs_dtype(path))
    if data.ndim != 2:
        raise ValueError("expected a 2-D array")
    n, d = data.shape
    hdr = np.full((n, 1), d, dtype=np.int32)
    out = np.concatenate([hdr.view(np.uint8).reshape(n, 4),
                          data.view(np.uint8).reshape(n, -1)], axis=1)
    with open(path, "wb") as f:
        out.tofile(f)


def load_fvecs(path, from_row: int = 0, num: int | None = None) -> np.ndarray:
    return load_vecs(path, from_row, num)


def load_bvecs(path, from_row: int = 0, num: int | None = None) -> np.ndarray:
    return load_vecs(path, from_row, num)


def load_ivecs(path, from_row: int = 0, num: int | None = None) -> np.ndarray:
    return load_vecs(path, from_row, num)


def store_fvecs(path, data) -> None:
    store_vecs(path, np.asarray(data, dtype=np.float32))


def store_bvecs(path, data) -> None:
    store_vecs(path, np.asarray(data, dtype=np.uint8))


def store_ivecs(path, data) -> None:
    store_vecs(path, np.asarray(data, dtype=np.int32))


def load_hdf5_dataset(path: str | os.PathLike) -> dict:
    """Load an ANN-benchmarks HDF5 file (train/test/neighbors/distances)."""
    import h5py  # noqa: PLC0415 -- optional dependency, needed only here

    out = {}
    with h5py.File(path, "r") as f:
        for key in ("train", "test", "neighbors", "distances"):
            if key in f:
                out[key] = np.asarray(f[key])
        if "distance" in f.attrs:
            dist = f.attrs["distance"]
            out["distance"] = dist.decode() if isinstance(dist, bytes) else str(dist)
    return out


class Dataset:
    """A host-resident 2-D dataset (base / query / ground-truth ids).

    Equivalent of the reference's ``Dataset<T>`` (nanobind.cu:157-182):
    construct from any array-like, ``load``/``store`` TEXMEX files, expose
    ``N``/``D``. float32, uint8 and int32 payloads (ValueT/BaseT/KeyT).
    """

    __slots__ = ("data",)

    def __init__(self, data):
        arr = np.asarray(data)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2:
            raise ValueError("Dataset expects a 2-D array")
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        if arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        if arr.dtype not in (np.float32, np.uint8, np.int32):
            raise ValueError(f"unsupported dtype {arr.dtype}")
        self.data = np.ascontiguousarray(arr)

    @classmethod
    def load(cls, path, from_row: int = 0, num: int | None = None) -> "Dataset":
        return cls(load_vecs(path, from_row, num))

    def store(self, path) -> None:
        store_vecs(path, self.data)

    @property
    def N(self) -> int:
        return self.data.shape[0]

    @property
    def D(self) -> int:
        return self.data.shape[1]

    def numel(self) -> int:
        return self.data.size

    def clone(self) -> np.ndarray:
        return self.data.copy()

    @property
    def view(self) -> np.ndarray:
        return self.data

    @property
    def device(self) -> str:
        return "cpu"

    def __array__(self, dtype=None, copy=None):
        if dtype is not None:
            return self.data.astype(dtype)
        return self.data

    def __len__(self) -> int:
        return self.N

    def __repr__(self) -> str:
        return f"Dataset(N={self.N}, D={self.D}, dtype={self.data.dtype})"


def _typed(name: str, dtype):
    """A reference-named constructor (nanobind.cu:110-129) that casts to
    its payload type; ``.load`` reads a file as ``Dataset.load`` does."""

    def make(data=None):
        return Dataset(np.asarray(data, dtype=dtype))

    make.__name__ = make.__qualname__ = name
    make.load = Dataset.load
    return make


FloatDataset = _typed("FloatDataset", np.float32)
UCharDataset = _typed("UCharDataset", np.uint8)
IntDataset = _typed("IntDataset", np.int32)
