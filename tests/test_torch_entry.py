"""``ggnn_torch.entry`` against the JAX package's ``__graft_entry__``.

* ``entry("cpu")``'s inputs equal the JAX ``entry()``'s, carried across by
  ``ggnn_torch.convert``, bit for bit for every drawn array (the squared
  norms ``base_sq`` / ``rep_sq`` are sums: rtol 1e-6).
* The port's tile on its own inputs against ``jax.jit`` of the JAX tile
  (the XLA oracle of the adjacency kernel): ids equal in every row, dists
  at rtol 1e-5 / atol 1e-4 (f32 summation order).
* ``dryrun_multichip(8, device="cpu")`` passes its checks over 8 CPU slots
  (8 build workers, the device merge); its brute force equals a numpy
  brute force over the whole base.
* ``convert`` takes JAX's read-only arrays without a warning.
* ``ggnn_torch/entry.py`` imports neither ``jax`` nor ``ggnn_tpu``.
"""

import ast
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import ggnn_tpu.graph
from ggnn_torch.convert import fused_index_from_numpy, graph_from_numpy
from ggnn_torch.entry import dryrun_multichip, entry
from ggnn_tpu.config import GraphConfig as JGraphConfig
from torch_reference import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX entry's (fn, args), imported as ``tests/test_sharding.py``
    imports it."""
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(str(REPO))
    try:
        import __graft_entry__

        yield __graft_entry__.entry()
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_entry():
    return entry("cpu")


def test_entry_inputs_equal_jax(jax_entry, port_entry):
    _, (j_query, j_index, j_base, j_base_sq, j_tau) = jax_entry
    _, (query, index, base, base_sq, tau) = port_entry
    want = fused_index_from_numpy(j_index)
    assert torch.equal(query, torch.from_numpy(np.array(j_query)))
    assert torch.equal(base, torch.from_numpy(np.array(j_base)))
    assert float(tau) == float(j_tau)
    for name in index._fields:
        got, exp = getattr(index, name), getattr(want, name)
        assert got.dtype == exp.dtype and got.shape == exp.shape, name
        if name == "rep_sq":
            np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=1e-6)
        else:
            assert torch.equal(got, exp), name
    np.testing.assert_allclose(base_sq.numpy(), np.asarray(j_base_sq), rtol=1e-6)


def test_entry_tile_equals_jax(jax_entry, port_entry):
    j_fn, j_args = jax_entry
    fn, args = port_entry
    j_ids, j_dists = (np.asarray(x) for x in jax.jit(j_fn)(*j_args))
    ids, dists = fn(*args)
    assert ids.shape == (256, 10) and dists.shape == (256, 10)
    np.testing.assert_array_equal(ids.numpy(), j_ids)
    np.testing.assert_allclose(dists.numpy(), j_dists, rtol=1e-5, atol=1e-4)


def test_dryrun_multichip_cpu_slots(capsys):
    out = dryrun_multichip(8, device="cpu")
    assert "dryrun_multichip(8): OK" in capsys.readouterr().out
    assert out["route"] == "devices" and out["workers"] == 8
    assert out["slots"] == ["cpu"] * 8
    # the dry run's data: 8 shards of 128 points, D=32, then 16 queries
    rng = np.random.default_rng(0)
    base = rng.normal(size=(8 * 128, 32)).astype(np.float32)
    query = rng.normal(size=(16, 32)).astype(np.float32)
    d = ((query[:, None].astype(np.float64) - base[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(out["bf_ids"], np.argsort(d, axis=1)[:, :4])
    for name in ("row_ids", "fused_ids", "ggnn_ids"):
        ids = out[name]
        assert ids.shape == (16, 4), name
        assert ((ids >= 0) & (ids < 8 * 128)).all(), name


def test_convert_takes_read_only_arrays_without_warning(jax_entry, monkeypatch):
    """No warning, and (since torch warns once per process) no read-only
    array reaches ``torch.from_numpy`` at all."""
    _, (_, j_index, *_) = jax_entry
    j_graph = ggnn_tpu.graph.empty_graph(JGraphConfig.create(N=256, D=16,
                                                             KBuild=8))
    assert not np.asarray(j_index.blocks).flags.writeable
    from_numpy, read_only = torch.from_numpy, []

    def spy(a):
        read_only.append(not a.flags.writeable)
        return from_numpy(a)

    monkeypatch.setattr(torch, "from_numpy", spy)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        index = fused_index_from_numpy(j_index)
        graph = graph_from_numpy(j_graph)
    monkeypatch.undo()
    assert read_only and not any(read_only)
    assert torch.equal(index.blocks, torch.from_numpy(np.array(j_index.blocks)))
    assert torch.equal(graph.neighbors[0], torch.full((256, 8), -1,
                                                      dtype=torch.int32))


def test_entry_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((REPO / "ggnn_torch" / "entry.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert names and not any(n.split(".")[0] in ("jax", "jaxlib", "ggnn_tpu")
                             or n == "__graft_entry__" for n in names), names


def test_entry_other_sizes_keep_the_draw_order():
    """At other sizes the inputs come from the same draws, in the same
    order (the codes row-chunked, equal to one draw), and the tile runs."""
    fn, args = entry("cpu", n=512, batch=32, k_build=8)
    _, index, base, _, _ = args
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(base.numpy(),
                                  rng.normal(size=(512, 128)).astype(np.float32))
    np.testing.assert_array_equal(index.nbr_ids.numpy(),
                                  rng.integers(0, 512, size=(512, 8)))
    np.testing.assert_array_equal(index.blocks.numpy(),
                                  rng.integers(0, 256, size=(512, 8, 128)))
    ids, dists = fn(*args)
    assert ids.shape == (32, 10) and torch.isfinite(dists).all()
    assert ((ids >= 0) & (ids < 512)).all()
