"""The port's dataset readers/writers and benchmark CLI against the JAX
package's: TEXMEX files written by either package are byte-identical and
read back identically (with ``from_row``/``num``), and ``python -m
ggnn_torch.benchmark --device cpu`` builds, stores, reloads and prints c@1
(the port's version of ``tests/test_benchmark_cli.py``).
"""

import numpy as np
import pytest
import torch

from ggnn_tpu import dataset as jds
from ggnn_torch import dataset as tds
from ggnn_torch.benchmark import build_parser, main

CASES = {
    ".fvecs": lambda rng: rng.random((37, 12), dtype=np.float32),
    ".bvecs": lambda rng: rng.integers(0, 256, (37, 12)).astype(np.uint8),
    ".ivecs": lambda rng: rng.integers(-5, 10**6, (37, 12)).astype(np.int32),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and beside other test
    processes their spinning costs many times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ext", sorted(CASES))
def test_vecs_roundtrip_matches_reference(tmp_path, ext):
    data = CASES[ext](np.random.default_rng(5))
    mine, theirs = tmp_path / f"port{ext}", tmp_path / f"jax{ext}"
    tds.store_vecs(mine, data)
    jds.store_vecs(theirs, data)
    assert mine.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(tds.load_vecs(mine), data)
    for from_row, num in ((0, None), (5, 10), (30, 100), (36, 1)):
        got = tds.load_vecs(theirs, from_row, num)
        want = jds.load_vecs(mine, from_row, num)
        assert got.dtype == want.dtype == data.dtype
        np.testing.assert_array_equal(got, want)
    loader = {".fvecs": tds.load_fvecs, ".bvecs": tds.load_bvecs,
              ".ivecs": tds.load_ivecs}[ext]
    np.testing.assert_array_equal(loader(mine, 2, 3), data[2:5])
    with pytest.raises(ValueError):
        tds.load_vecs(mine, 37)


def test_dataset_classes_match_reference(tmp_path):
    data = np.random.default_rng(1).random((9, 4))  # float64: downcast
    for make, jmake in ((tds.FloatDataset, jds.FloatDataset),
                        (tds.UCharDataset, jds.UCharDataset),
                        (tds.IntDataset, jds.IntDataset)):
        mine, theirs = make(data * 100), jmake(data * 100)
        assert mine.data.dtype == theirs.data.dtype
        np.testing.assert_array_equal(mine.data, theirs.data)
        assert (mine.N, mine.D, len(mine)) == (9, 4, 9)
    ds = tds.Dataset(data)
    assert ds.data.dtype == np.float32
    ds.store(tmp_path / "d.fvecs")
    np.testing.assert_array_equal(tds.FloatDataset.load(tmp_path / "d.fvecs", 3, 2).data,
                                  ds.data[3:5])
    with pytest.raises(ValueError):
        tds.Dataset(np.zeros((2, 2, 2)))
    with pytest.raises(ValueError):
        tds.store_vecs(tmp_path / "d.txt", ds.data)


def test_ggnn_accepts_dataset():
    from ggnn_torch import GGNN

    base = tds.FloatDataset(np.random.default_rng(2).random((256, 8)))
    g = GGNN(device="cpu")
    g.set_base(base)
    ids, _ = g.bf_query(base.data[:4], k_gt=1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(4))


def test_parser_defaults():
    args = build_parser().parse_args(["--base", "x.fvecs"])
    want = build_parser_reference().parse_args(["--base", "x.fvecs"])
    for name, value in vars(want).items():
        assert getattr(args, name) == value, name
    assert args.device == "cuda"


def build_parser_reference():
    from ggnn_tpu.benchmark import build_parser as jbuild_parser

    return jbuild_parser()


def test_cli_end_to_end_fvecs(tmp_path, capsys, caplog):
    rng = np.random.default_rng(11)
    base = rng.random((1024, 16), dtype=np.float32)
    query = rng.random((64, 16), dtype=np.float32)
    tds.store_fvecs(tmp_path / "base.fvecs", base)
    tds.store_fvecs(tmp_path / "query.fvecs", query)
    argv = [
        "--base", str(tmp_path / "base.fvecs"),
        "--query", str(tmp_path / "query.fvecs"),
        "--gt", str(tmp_path / "gt.ivecs"),
        "--graph_dir", str(tmp_path / "graph"),
        "--shard_size", "512", "--fused_group", "2",
        "--k_build", "8", "--k_query", "4", "--max_iterations", "64",
        "--device", "cpu",
    ]
    assert main(argv) == 0
    first = capsys.readouterr().out
    # both parts and their sidecars, and the ground truth, were stored
    for i in range(2):
        assert (tmp_path / "graph" / f"part_{i}.npz").exists()
        assert (tmp_path / "graph" / f"part_{i}.fused.npz").exists()
    assert (tmp_path / "gt.ivecs").exists()
    # the second invocation takes the load path and reuses everything
    caplog.clear()
    assert main(argv) == 0
    second = capsys.readouterr().out
    assert "fused index: 2 of 2 shards from their sidecars" in caplog.text
    for out in (first, second):
        assert out.count("c@1") == 4
    # same graph, same sidecars: the same recall lines
    recall = [line for line in first.splitlines() if line.startswith(("c@", "r@"))]
    assert recall == [line for line in second.splitlines()
                      if line.startswith(("c@", "r@"))]
