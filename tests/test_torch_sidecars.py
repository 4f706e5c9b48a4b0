"""Fused-index sidecars through the port's ``GGNN`` store/load: the port's
versions of the JAX package's persistence tests
(``tests/test_persistence.py``), plus the sidecar that a rotation reuses.
"""

import numpy as np
import pytest
import torch

from ggnn_torch import GGNN
from ggnn_torch.query.fused import fused_index_matches_graph, load_fused_index

N, D, KB = 512, 16, 12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and beside other test
    processes their spinning costs many times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _built(base, path, group=None):
    g = GGNN(device="cpu")
    g.set_base(base)
    g.set_working_directory(path)
    g.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
    if group is not None:
        g.build_fused_index(group=group)
    return g


def _loaded(base, path):
    g = GGNN(device="cpu")
    g.set_base(base)
    g.set_working_directory(path)
    g.load(k_build=KB)
    return g


def test_stale_fused_sidecar_ignored_on_load(tmp_path, rng):
    base_a = rng.normal(size=(N, D)).astype(np.float32)
    g = _built(base_a, tmp_path, group=1)
    g.store()
    assert (tmp_path / "part_0.fused.npz").exists()
    stale = (tmp_path / "part_0.fused.npz").read_bytes()

    # a different base -> a different graph, stored WITHOUT a fused index
    base_b = rng.normal(size=(N, D)).astype(np.float32)
    g2 = _built(base_b, tmp_path)
    g2.store()
    assert not (tmp_path / "part_0.fused.npz").exists()

    # even if the stale sidecar reappears on disk, load() must reject it
    (tmp_path / "part_0.fused.npz").write_bytes(stale)
    g3 = _loaded(base_b, tmp_path)
    assert not g3.has_fused_index()


def test_matching_fused_sidecar_survives_roundtrip(tmp_path, rng):
    base = rng.normal(size=(N, D)).astype(np.float32)
    query = rng.normal(size=(8, D)).astype(np.float32)
    g = _built(base, tmp_path, group=1)
    ids1, _ = g.query(query, 10, tau_query=0.5, max_iterations=100, engine="fused")
    g.store()
    g2 = _loaded(base, tmp_path)
    assert g2.has_fused_index()
    ids2, _ = g2.query(query, 10, tau_query=0.5, max_iterations=100, engine="fused")
    np.testing.assert_array_equal(ids1, ids2)


def test_group_mismatched_sidecar_triggers_rebuild(tmp_path, rng):
    base = rng.normal(size=(N, D)).astype(np.float32)
    query = rng.normal(size=(8, D)).astype(np.float32)
    g = _built(base, tmp_path, group=2)
    g.store()

    g2 = _loaded(base, tmp_path)
    assert g2.has_fused_index()  # the group=2 meta sidecar loaded
    g2.build_fused_index(group=1)  # another group: must NOT reuse it
    idx = g2._shards[0].fused_index
    assert idx is not None and idx.group == 1
    assert g2._shards[0].fused_index_host is None  # stale meta dropped
    assert g2.tier_stats["sidecar_reuses"] == 0
    g2.query(query, 10, tau_query=0.5, max_iterations=100, engine="fused")

    # another code width is another layout too
    g4 = _loaded(base, tmp_path)
    g4.build_fused_index(group=2, bits=4)
    assert g4.tier_stats["sidecar_reuses"] == 0
    assert g4._shards[0].fused_index.bits == 4

    # same group and bits: the sidecar is reused bit for bit
    g3 = _loaded(base, tmp_path)
    g3.build_fused_index(group=2)
    assert g3.tier_stats["sidecar_reuses"] == 1
    assert g3._shards[0].fused_index.group == 2
    ids3, _ = g3.query(query, 10, tau_query=0.5, max_iterations=100, engine="fused")
    ids1, _ = g.query(query, 10, tau_query=0.5, max_iterations=100, engine="fused")
    np.testing.assert_array_equal(ids3, ids1)


def test_legacy_fused_sidecar_rejected_not_crashing(tmp_path, rng):
    base = rng.normal(size=(N, D)).astype(np.float32)
    g = _built(base, tmp_path, group=1)
    g.store()
    sidecar = tmp_path / "part_0.fused.npz"
    with np.load(sidecar, allow_pickle=False) as f:
        legacy = {k: f[k] for k in f.files if k != "graph_fp"}
    np.savez(sidecar, **legacy)

    meta = load_fused_index(sidecar)  # must not raise
    assert not np.any(meta.graph_fp)
    assert not fused_index_matches_graph(meta, g.get_graph(), KB)
    assert not _loaded(base, tmp_path).has_fused_index()  # rejected, not trusted

    sidecar.write_bytes(b"not a zip archive")  # unreadable: rejected as well
    assert not _loaded(base, tmp_path).has_fused_index()


def test_store_after_spill_writes_every_part(tmp_path, rng):
    """Out of core with a CPU memory limit, shards live in spill files; a
    later store() writes every part and its sidecar from them."""
    base = rng.normal(size=(4 * N, D)).astype(np.float32)
    query = rng.normal(size=(8, D)).astype(np.float32)
    g = GGNN(device="cpu")
    g.set_base(base)
    g.set_shard_size(N)
    g.set_max_device_shards(1)
    g.set_cpu_memory_limit(1)  # no working directory: spills go to a temp dir
    try:
        g.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
        g.build_fused_index(group=2)
        assert g.has_graph() and g.has_fused_index()
        ids, _ = g.query(query, 10, 0.5, 100, engine="fused")
        assert g.tier_stats["spills"] > 0
        g.set_working_directory(tmp_path / "out")
        g.store()
    finally:
        g.close()
    assert len(list((tmp_path / "out").glob("part_*.fused.npz"))) == 4
    g2 = GGNN(device="cpu")
    g2.set_base(base)
    g2.set_shard_size(N)
    g2.set_working_directory(tmp_path / "out")
    g2.load(k_build=KB)
    g2.build_fused_index(group=2)
    assert g2.tier_stats["sidecar_reuses"] == 4
    np.testing.assert_array_equal(g2.query(query, 10, 0.5, 100, engine="fused").ids,
                                  ids)
