"""The port's main path on the card against the same code on the CPU.

Card-only (marker ``cuda``); these tests import no JAX, so they run on a
machine without it::

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py

* The fused query on one graph and index, once on the card (the CUDA
  kernel) and once on the CPU (its plain version): ids equal on >= 99% of
  rows -- only the f32 summation order differs.
* The row engine on one graph, once on the card and once on the CPU: ids
  equal on >= 99% of rows, distances within 1e-4 relative (f32 order).
* A build on the card reaches the recall of a build on the CPU within
  0.01 c@1: the two draw different selection uniforms (a CUDA and a CPU
  generator), so the graphs differ like two seeds do.
* The group-2 and int4 fused layouts on one graph, queried on the card and
  on the CPU: ids equal on >= 99% of rows; the int4 queries launch the
  kernel in ``nibbles`` mode.
* Two slots of one card: two build workers capturing their walks' CUDA
  graphs, each launch counted exactly once -- through the replays of the
  graphs it was captured into -- with the interpreter switching threads
  every microsecond, and the device merge returning the host merge's ids.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from ggnn_torch import GGNN, Evaluator
from ggnn_torch.ops import adjacency
from ggnn_torch.query.ann import ann_query
from ggnn_torch.query.fused import FusedIndex, build_fused_index, fused_query
from torch_reference import one_torch_thread  # noqa: F401

N, NQ, D, K = 4096, 1000, 128, 24


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, D)).astype(np.float32) / 4.0

    def sample(m):
        z = rng.normal(size=(m, 16)).astype(np.float32)
        x = z @ w * 40.0 + 128.0 + rng.normal(0, 4, size=(m, D)).astype(np.float32)
        return np.clip(x, 0, 255).astype(np.float32)

    return sample(N), sample(NQ)


@pytest.fixture(scope="module")
def built(cuda_device, data):
    base, query = data
    g = GGNN(device=cuda_device)
    g.set_base(base)
    before = adjacency.launches
    g.build(k_build=K, tau_build=0.5, refinement_iterations=2)
    assert adjacency.launches > before  # the build's merges ran the kernel
    g.build_fused_index()
    gt, _ = g.bf_query(query, k_gt=100)
    return g, gt


@pytest.mark.cuda
def test_query_card_matches_cpu(cuda_device, data, built):
    base, query = data
    g, _ = built
    shard = g._shards[0]
    index = shard.fused_index
    cpu_index = FusedIndex(*(t.cpu() for t in index))
    kw = dict(num_seeds=8, rerank=16, width=32, cap=32, pops_per_iter=4)
    before = adjacency.launches
    ids, dists = fused_query(torch.from_numpy(query).to(cuda_device), index,
                             shard.base_dev, 10, 0.5, 16, **kw)
    torch.cuda.synchronize()
    assert adjacency.launches > before
    cpu_ids, cpu_dists = fused_query(torch.from_numpy(query), cpu_index,
                                     torch.from_numpy(base), 10, 0.5, 16, **kw)
    same = np.mean(np.all(ids.cpu().numpy() == cpu_ids.numpy(), axis=1))
    assert same >= 0.99
    np.testing.assert_allclose(dists.cpu().numpy(), cpu_dists.numpy(),
                               rtol=1e-4, atol=1e-2)


@pytest.mark.cuda
def test_row_query_card_matches_cpu(cuda_device, data, built):
    base, query = data
    g, _ = built
    graph = g.get_graph()
    cpu_graph = graph.to("cpu")
    before = adjacency.launches
    ids, dists = ann_query(torch.from_numpy(query).to(cuda_device),
                           g._shards[0].base_dev, graph, g._cfg, 10, 0.5, 64)
    torch.cuda.synchronize()
    assert adjacency.launches == before  # the row walk runs no kernel
    cpu_ids, cpu_dists = ann_query(torch.from_numpy(query),
                                   torch.from_numpy(base), cpu_graph, g._cfg,
                                   10, 0.5, 64)
    same = np.mean(np.all(ids.cpu().numpy() == cpu_ids.numpy(), axis=1))
    assert same >= 0.99
    np.testing.assert_allclose(dists.cpu().numpy(), cpu_dists.numpy(),
                               rtol=1e-4, atol=1e-2)


@pytest.mark.cuda
def test_card_build_recall_matches_cpu_build(cuda_device, data, built):
    base, query = data
    g, gt = built
    cpu = GGNN(device="cpu")
    cpu.set_base(base)
    cpu.build(k_build=K, tau_build=0.5, refinement_iterations=2)
    cpu.build_fused_index()
    cpu_gt, _ = cpu.bf_query(query, k_gt=100)
    assert np.mean(gt == cpu_gt) >= 0.999
    evaluator = Evaluator(base, query, cpu_gt, k_query=10)
    kw = dict(engine="fused", num_seeds=8, rerank=16, width=32, cap=32,
              pops_per_iter=4)
    c1 = evaluator.evaluate_results(g.query(query, 10, 0.5, 24, **kw).ids).c1
    cpu_c1 = evaluator.evaluate_results(cpu.query(query, 10, 0.5, 24, **kw).ids).c1
    assert abs(c1 - cpu_c1) <= 0.01, (c1, cpu_c1)


@pytest.mark.cuda
@pytest.mark.parametrize("group, bits", [(2, 8), (1, 4)])
def test_layout_query_card_matches_cpu(cuda_device, data, built, group, bits):
    base, query = data
    g, _ = built
    shard = g._shards[0]
    index = build_fused_index(shard.base_dev, shard.graph, g._cfg, group=group,
                              bits=bits)
    assert index.group == group and index.bits == bits
    cpu_index = FusedIndex(*(t.cpu() for t in index))
    kw = dict(num_seeds=8, rerank=16, width=32, cap=32, pops_per_iter=4)
    before, before_nib = adjacency.launches, adjacency.launches_nibbles
    ids, _ = fused_query(torch.from_numpy(query).to(cuda_device), index,
                         shard.base_dev, 10, 0.5, 24, **kw)
    torch.cuda.synchronize()
    assert adjacency.launches > before
    assert (adjacency.launches_nibbles > before_nib) == (bits == 4)
    cpu_ids, _ = fused_query(torch.from_numpy(query), cpu_index,
                             torch.from_numpy(base), 10, 0.5, 24, **kw)
    same = np.mean(np.all(ids.cpu().numpy() == cpu_ids.numpy(), axis=1))
    assert same >= 0.99


@pytest.mark.cuda
def test_two_slots_on_one_card(cuda_device, data):
    """Every launch counted exactly once: a wrapper around the kernel's
    entry point counts the calls made outside a graph capture, and each
    replay of a graph adds the calls made while that graph was captured
    (read from ``torch.cuda.CUDAGraph`` itself, not from the port's
    accounting)."""
    base, query = data
    adjacency._load()
    launch, calls, lock = adjacency._launch_fn, [0], threading.Lock()
    captured, tls = {}, threading.local()
    cls = torch.cuda.CUDAGraph
    begin, end, replay = cls.capture_begin, cls.capture_end, cls.replay

    def counted(*args):
        if torch.cuda.is_current_stream_capturing():
            tls.n += 1
        else:
            with lock:
                calls[0] += 1
        return launch(*args)

    def capture_begin(self, *args, **kwargs):
        tls.n = 0
        return begin(self, *args, **kwargs)

    def capture_end(self):
        end(self)
        captured[id(self)] = tls.n

    def replayed(self):
        replay(self)
        with lock:
            calls[0] += captured[id(self)]

    g = GGNN(device=cuda_device)
    g.set_devices([cuda_device, cuda_device])
    g.set_base(base)
    before = adjacency.launches
    adjacency._launch_fn = counted
    cls.capture_begin, cls.capture_end, cls.replay = capture_begin, capture_end, replayed
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        g.build(k_build=K, tau_build=0.5, refinement_iterations=2)
    finally:
        sys.setswitchinterval(interval)
        adjacency._launch_fn = launch
        cls.capture_begin, cls.capture_end, cls.replay = begin, end, replay
    assert g.last_build_stats["num_build_workers"] == 2
    assert sum(s["graphs_captured"] for s in g.last_build_stats["shards"]) > 0
    assert calls[0] > 0 and adjacency.launches - before == calls[0]
    g.build_fused_index()
    kw = dict(engine="fused", num_seeds=8, rerank=16, width=32, cap=32,
              pops_per_iter=4)
    on_device = g.query(query, 10, 0.5, 24, **kw)
    assert g.last_merge_route == "devices"
    g.set_device_merge(False)
    on_host = g.query(query, 10, 0.5, 24, **kw)
    assert g.last_merge_route == "host"
    np.testing.assert_array_equal(on_device.ids, on_host.ids)
    np.testing.assert_array_equal(on_device.dists, on_host.dists)
    g.close()
