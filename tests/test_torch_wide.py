"""The port at GIST1M's width (D = 960) end to end, and the counts that
the benchmark's wide-kernel metrics read.

CPU cases (no JAX; 2,048 points of the gist1m configuration's data model,
``annbench/data.py``):

* ``GGNN.build`` -> ``build_fused_index`` -> ``GGNN.query(engine="fused")``
  at the gist1m configuration's engine and operating point, held against
  the benchmark's plain reference (``annbench/reference.py``):
  every id in the base and none twice in a row, every returned distance
  within the configuration's ``dist_gap`` of the float64 distance of its
  id, and the exact 10 nearest found up to a recall floor.
* While a profiler records, the fused walk counts the anchors it hands
  the adjacency kernel (``adjacency.fetched_anchors``) as the visited
  ring's new entries; the count equals the anchors >= 0 of every call of
  the kernel, and nothing is counted without a profiler or where a group's
  members share one fetch.

The CPU build is lighter than the configuration's (k_build 12, no
refinement: its plain fetches at 960 dims take seconds a merge step); the
card case builds as the configuration says.

Card case (marker ``cuda``; skipped without a card)::

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_wide.py

* The same query on the card launches the wide adjacency kernel and the
  gather + distance's four-slab instance, counted by variant.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from annbench import data, reference
from ggnn_torch import GGNN
from ggnn_torch.ops import adjacency, gather_dist
from ggnn_torch.query import fused
from torch_reference import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "annbench" / "configs" / "gist1m.json").read_text())
N, NQ, SEED = 2048, 200, 2**31 + 960
CPU_BUILD = dict(k_build=12, tau_build=CFG["tau_build"], refinement_iterations=0)


@pytest.fixture(scope="module")
def built():
    torch.manual_seed(0)
    base, pool = data.generate(CFG["data"], N, CFG["dim"], NQ, SEED, "cpu")
    g = GGNN(device="cpu")
    g.set_base(base.numpy())
    g.build(**CPU_BUILD)
    g.build_fused_index(group=CFG["group"], bits=CFG["bits"])
    yield g, base, pool
    g.close()


def _query(g, pool):
    kw = dict(CFG["engine_kwargs"], pops_per_iter=CFG["pops_per_iter"])
    ids, dists = g.query(pool.numpy(), CFG["k_query"], CFG["tau_query"],
                         CFG["max_iterations"], engine="fused", **kw)
    return np.asarray(ids), np.asarray(dists)


def test_fused_query_at_960_dims_against_the_reference(built):
    g, base, pool = built
    ids, dists = _query(g, pool)
    assert ids.shape == dists.shape == (NQ, CFG["k_query"])
    gt = reference.exact_knn(base, pool, 10)[0].numpy()
    recall = reference.recall_hits(ids, gt).sum() / gt.size
    checks = reference.judge(base, pool, np.arange(NQ), ids, dists,
                             CFG["limits"], recall=recall)
    assert checks["bad_ids"]["value"] == 0 and checks["dup_rows"]["value"] == 0
    assert checks["dist_gap"]["value"] <= checks["dist_gap"]["limit"]
    assert recall >= 0.9, recall


def test_traced_walk_counts_the_anchors_it_fetches(built, monkeypatch):
    g, _, pool = built
    handed = []
    kernel = fused.adjacency_dot

    def counting(qs, anchors, blocks, **kw):
        handed.append(int((anchors >= 0).sum()))
        return kernel(qs, anchors, blocks, **kw)

    monkeypatch.setattr(fused, "adjacency_dot", counting)
    key = adjacency.variant(CFG["dim"])
    assert key == ("u8", 32, True)
    before = adjacency.fetched_anchors().get(key, 0)
    a = _query(g, pool)
    assert adjacency.fetched_anchors().get(key, 0) == before and handed
    handed.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        b = _query(g, pool)
    assert adjacency.fetched_anchors()[key] - before == sum(handed) > 0
    assert all((x == y).all() for x, y in zip(a, b))


def test_groups_count_no_anchors(monkeypatch):
    """Where a group's members share one fetch the ring's entries are not
    the fetches: nothing is counted."""
    rng = np.random.default_rng(0)
    base = rng.random((1024, 32), dtype=np.float32)
    g = GGNN(device="cpu")
    g.set_base(base)
    g.build(k_build=12, tau_build=0.5, refinement_iterations=0)
    g.build_fused_index(group=2)
    before = adjacency.fetched_anchors()
    with profile(activities=[ProfilerActivity.CPU]):
        g.query(base[:64], 10, 0.5, 32, engine="fused")
    assert adjacency.fetched_anchors() == before
    g.close()


@pytest.mark.cuda
def test_cuda_query_at_960_dims_launches_the_wide_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    base, pool = data.generate(CFG["data"], 16_384, CFG["dim"], 1000, SEED, dev)
    g = GGNN(device=dev)
    g.set_base(base)
    g.build(k_build=CFG["k_build"], tau_build=CFG["tau_build"],
            refinement_iterations=CFG["refinement_iterations"])
    g.build_fused_index(group=CFG["group"], bits=CFG["bits"])
    wide = adjacency.variant(CFG["dim"])
    slabs = gather_dist.variant(1, CFG["dim"], False)
    a0 = adjacency.variant_launches().get(wide, 0)
    s0 = gather_dist.variant_launches().get(slabs, 0)
    kw = dict(CFG["engine_kwargs"], pops_per_iter=CFG["pops_per_iter"])
    ids, dists = g.query(pool, CFG["k_query"], CFG["tau_query"],
                         CFG["max_iterations"], engine="fused", **kw)
    torch.cuda.synchronize(dev)
    assert adjacency.variant_launches()[wide] > a0
    assert gather_dist.variant_launches()[slabs] == s0 + 1  # the re-rank
    gt = reference.exact_knn(base, pool, 10)[0].cpu().numpy()
    ids = np.asarray(torch.as_tensor(ids).cpu())
    assert reference.recall_hits(ids, gt).sum() / gt.size >= 0.9
    g.close()
