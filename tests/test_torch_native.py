"""The port's native host runtime (``ggnn_torch/native``) against numpy and
the JAX package's own native runtime (``ggnn_tpu.native``).

* The TEXMEX reader/writer round-trips, and reads rows byte-equal to the
  numpy reader and to ``ggnn_tpu.native.io``; ``dataset.load_vecs`` takes
  it where it is built.
* The k-way merger equals the numpy stable merge and ``ggnn_tpu.native``'s
  merger, with and without ``id_offset_scale``; among equal distances it
  keeps the stable merge's order (the lower partition first), which the
  device merge keeps too.
* ``GGNN._merge_on_host`` falls back to numpy loudly where the merger
  raises or is not built.
* Libraries are named by a hash of their source and flags: two sources
  give two names, and ``GGNN_TORCH_CACHE`` moves the directory (the native
  library built there with g++; for the CUDA kernel only the name, which
  needs no nvcc).
"""

import logging

import numpy as np
import pytest
import torch

from ggnn_torch import GGNN, dataset
from ggnn_torch.native import build as native_build
from ggnn_torch.native import io as native_io
from ggnn_torch.native import merge as native_merge
from ggnn_torch.ops import adjacency
from ggnn_torch.parallel import merge_over_devices
from ggnn_tpu.native import io as j_native_io
from ggnn_tpu.native import merge as j_native_merge
from torch_reference import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    if not (native_io.available() and j_native_io.available()):
        pytest.skip("no g++ to build the native runtimes")


def _numpy_merge(ids, dists, k):
    all_d = np.concatenate(list(dists), axis=1)
    all_i = np.concatenate(list(ids), axis=1)
    order = np.argsort(all_d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(all_i, order, 1), np.take_along_axis(all_d, order, 1)


def test_vecs_roundtrip(tmp_path):
    data = np.random.default_rng(0).normal(size=(23, 11)).astype(np.float32)
    path = tmp_path / "x.fvecs"
    native_io.store_vecs(path, data)
    np.testing.assert_array_equal(native_io.load_vecs(path, np.float32), data)
    np.testing.assert_array_equal(
        native_io.load_vecs(path, np.float32, from_row=5, num=3), data[5:8])
    with pytest.raises(ValueError, match="beyond"):
        native_io.load_vecs(path, np.float32, from_row=23)


@pytest.mark.parametrize("ext, dtype", [(".fvecs", np.float32),
                                        (".bvecs", np.uint8),
                                        (".ivecs", np.int32)])
def test_rows_byte_equal_to_numpy_and_jax_readers(tmp_path, ext, dtype):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 255, (31, 7)).astype(dtype)
    path = tmp_path / f"x{ext}"
    dataset.store_vecs(path, data)  # the numpy writer
    for from_row, num in ((0, None), (4, 9), (30, 5)):
        mine = native_io.load_vecs(path, dtype, from_row, num)
        numpy_rows = dataset._load_vecs_numpy(path, dtype, from_row, num)
        jax_rows = j_native_io.load_vecs(str(path), dtype, from_row, num)
        assert mine.tobytes() == numpy_rows.tobytes() == jax_rows.tobytes()
        # the package's reader is the native one where it is built
        assert dataset.load_vecs(path, from_row, num).tobytes() == mine.tobytes()
    native_io.store_vecs(tmp_path / f"y{ext}", data)
    assert (tmp_path / f"y{ext}").read_bytes() == path.read_bytes()


@pytest.mark.parametrize("offset", [0, 1000])
def test_merge_equals_numpy_and_jax_merger(offset):
    rng = np.random.default_rng(2)
    P, Q, S, K = 4, 300, 8, 6  # Q >= 128: the threaded path
    dists = np.sort(rng.normal(size=(P, Q, S)).astype(np.float32), axis=-1)
    ids = rng.integers(0, 1000, (P, Q, S)).astype(np.int32)
    out_ids, out_d = native_merge.merge_topk_partials(
        ids, dists, K, id_offset_scale=offset, num_threads=4)
    glob = ids + (np.arange(P, dtype=np.int32) * offset)[:, None, None]
    want_ids, want_d = _numpy_merge(glob, dists, K)
    np.testing.assert_array_equal(out_ids, want_ids)
    np.testing.assert_array_equal(out_d, want_d)
    j_ids, j_d = j_native_merge.merge_topk_partials(ids, dists, K,
                                                    id_offset_scale=offset)
    np.testing.assert_array_equal(out_ids, j_ids)
    np.testing.assert_array_equal(out_d, j_d)


def test_merge_keeps_stable_tie_order():
    """Few distinct distances: ties across and within partitions everywhere.
    The merger equals the stable sort, and so the device merge."""
    rng = np.random.default_rng(3)
    P, Q, S, K = 3, 64, 8, 10
    dists = np.sort(rng.integers(0, 5, (P, Q, S)).astype(np.float32), axis=-1)
    ids = np.broadcast_to(np.arange(P * S, dtype=np.int32).reshape(P, 1, S),
                          (P, Q, S)).copy()
    out_ids, out_d = native_merge.merge_topk_partials(ids, dists, K)
    want_ids, want_d = _numpy_merge(ids, dists, K)
    np.testing.assert_array_equal(out_ids, want_ids)
    np.testing.assert_array_equal(out_d, want_d)
    dev_ids, dev_d = merge_over_devices(
        [(torch.from_numpy(i), torch.from_numpy(d)) for i, d in zip(ids, dists)], K)
    np.testing.assert_array_equal(dev_ids.numpy(), want_ids)


def test_merge_pads_short_partitions():
    ids = np.array([[[7, 8]], [[9, 10]]], np.int32)
    dists = np.array([[[1.0, 3.0]], [[2.0, 4.0]]], np.float32)
    out_ids, out_d = native_merge.merge_topk_partials(ids, dists, 6)
    np.testing.assert_array_equal(out_ids, [[7, 9, 8, 10, -1, -1]])
    assert np.isinf(out_d[0, 4:]).all()
    with pytest.raises(ValueError):
        native_merge.merge_topk_partials(ids[:, :, :0], dists[:, :, :0], 2)


@pytest.mark.parametrize("fault", ["raises", "not built"])
def test_merge_on_host_falls_back_loudly(monkeypatch, caplog, fault):
    """A failing or missing native merger falls back to the numpy merge with
    a warning: a silent fallback would hide a wrong result of the C++."""
    if fault == "raises":
        def boom(*a, **kw):
            raise RuntimeError("injected native merger fault")

        monkeypatch.setattr(native_merge, "merge_topk_partials", boom)
    else:
        monkeypatch.setattr(native_merge, "available", lambda: False)
    rng = np.random.default_rng(4)
    P, Q, S, K = 3, 16, 8, 5
    dists = np.sort(rng.normal(size=(P, Q, S)).astype(np.float32), axis=-1)
    ids = rng.integers(0, 10_000, (P, Q, S)).astype(np.int32)
    partials = [(torch.from_numpy(ids[p]), torch.from_numpy(dists[p]))
                for p in range(P)]
    with caplog.at_level(logging.WARNING, logger="ggnn_torch"):
        out_ids, out_d = GGNN._merge_on_host(partials, K)
    assert any("numpy merge instead" in r.message for r in caplog.records)
    want_ids, want_d = _numpy_merge(ids, dists, K)
    np.testing.assert_array_equal(out_ids, want_ids)
    np.testing.assert_array_equal(out_d, want_d)


def test_libraries_named_by_source_hash(tmp_path, monkeypatch):
    """Another source, or the same source elsewhere, is another library;
    ``GGNN_TORCH_CACHE`` moves the directory, and the native library builds
    there with g++ and loads."""
    other = tmp_path / "other.cu"
    other.write_bytes(adjacency.KERNEL_SOURCE.read_bytes() + b"\n// changed\n")
    mine, theirs = adjacency.library_path(), adjacency.library_path(other)
    assert mine.parent == theirs.parent and mine.name != theirs.name
    assert mine.name.startswith("adjacency_dot_") and mine.suffix == ".so"
    assert adjacency.library_path() == mine  # stable for one source
    cache = tmp_path / "cache"
    monkeypatch.setenv("GGNN_TORCH_CACHE", str(cache))
    assert adjacency.library_path() == cache / mine.name
    monkeypatch.setattr(native_build, "_lib", None)
    monkeypatch.setattr(native_build, "_tried", False)
    assert native_build.load() is not None
    assert native_build.library_path().parent == cache
    assert native_build.library_path().is_file()
    monkeypatch.setattr(native_build, "_lib", None)
    monkeypatch.setattr(native_build, "_tried", False)
    monkeypatch.setenv("GGNN_TORCH_NO_NATIVE", "1")
    assert native_build.load() is None
