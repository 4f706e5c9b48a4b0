"""``examples/torch_port/*.py`` run on the CPU at a tiny size.

Each example takes its sizes and its device as arguments (the reference's
sizes and ``cuda`` by default); here every one runs in this process on a
few hundred points of the CPU, the SIFT ones on small synthetic fvecs and
HDF5 files written by the test. The reference's examples are not run.
"""

import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ggnn_torch import store_fvecs, store_ivecs
from torch_reference import one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch_port"
TINY = ["--n", "1024", "--nq", "50", "--dim", "16", "--k_build", "12",
        "--device", "cpu"]


def _run(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [str(EXAMPLES / name), *argv])
    return runpy.run_path(str(EXAMPLES / name), run_name="example")["main"]()


@pytest.fixture(scope="module")
def sift_like():
    rng = np.random.default_rng(9)
    base = rng.normal(size=(1024, 16)).astype(np.float32)
    query = rng.normal(size=(50, 16)).astype(np.float32)
    d = ((query[:, None] - base[None]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1, kind="stable")[:, :100].astype(np.int32)
    return base, query, gt


def test_basic(monkeypatch):
    result = _run("basic.py", TINY, monkeypatch)
    assert result.c1 >= 0.9


def test_device_data(monkeypatch):
    ids, dists, result = _run("device_data.py", TINY, monkeypatch)
    assert isinstance(ids, torch.Tensor) and ids.shape == (50, 10)
    assert ids.device == torch.device("cpu") and result.c1 >= 0.9


def test_multi_device(monkeypatch):
    g, ids, dists = _run("multi_device.py", TINY + ["--n_shard", "256"],
                         monkeypatch)
    assert g.num_shards == 4 and len(g.devices) == 2
    assert g.last_build_stats["num_build_workers"] == 2
    assert g.last_merge_route == "host"  # two shards per slot
    assert ids.shape == (50, 10) and np.all(np.diff(dists, axis=1) >= 0)


def test_sift1m_fvecs(tmp_path, monkeypatch, sift_like):
    base, query, gt = sift_like
    store_fvecs(tmp_path / "sift_base.fvecs", base)
    store_fvecs(tmp_path / "sift_query.fvecs", query)
    store_ivecs(tmp_path / "sift_groundtruth.ivecs", gt)
    results = _run("sift1m_fvecs.py", [str(tmp_path), "--k_build", "12",
                                       "--device", "cpu"], monkeypatch)
    assert len(results) == 4 and results[-1].c1 >= 0.95


def test_sift1m_hdf5(tmp_path, monkeypatch, sift_like):
    h5py = pytest.importorskip("h5py")
    base, query, gt = sift_like
    path = tmp_path / "sift-like.hdf5"
    with h5py.File(path, "w") as f:
        f["train"], f["test"], f["neighbors"] = base, query, gt
    results = _run("sift1m_hdf5.py", [str(path), "--k_build", "12",
                                      "--device", "cpu"], monkeypatch)
    assert len(results) == 4 and results[-1].c1 >= 0.95
