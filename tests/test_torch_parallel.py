"""``ggnn_torch.parallel`` against the JAX package's ``parallel/sharded.py``.

The JAX package builds two 512-point shards and their fused indexes and
runs its ``shard_map`` queries over two (virtual) devices; the port runs
``sharded_*`` on the same graphs and indexes (carried across by
``ggnn_torch.convert``) as two slots of the CPU, given the ``rerank`` and
``cap`` that the JAX ``sharded_fused_query`` computes. Ids must equal on
>= 99% of rows (only f32 summation order differs; ``seed_approx=False``),
brute force up to exact distance ties. A second case shows that the port
forwards the caller's ``rerank``/``cap``/``width``, which the JAX function
recomputes or drops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_torch import GraphConfig
from ggnn_torch.convert import fused_index_from_numpy, graph_from_numpy
from ggnn_torch.parallel import (
    merge_over_devices,
    sharded_bf_query,
    sharded_fused_query,
    sharded_query,
)
from ggnn_torch.query.fused import fused_query
from ggnn_tpu.build.construction import build_graph as j_build_graph
from ggnn_tpu.config import GraphConfig as JGraphConfig
from ggnn_tpu.parallel import make_mesh, stack_shards
from ggnn_tpu.parallel import sharded_bf_query as j_sharded_bf_query
from ggnn_tpu.parallel import sharded_fused_query as j_sharded_fused_query
from ggnn_tpu.parallel import sharded_query as j_sharded_query
from ggnn_tpu.query.fused import build_fused_index as j_build_fused_index
from torch_reference import one_torch_thread  # noqa: F401

N_SHARD, D, KB, NQ, K = 512, 16, 12, 200, 10
TAU, ITERS, P = 0.7, 64, 8


@pytest.fixture(scope="module")
def shards():
    rng = np.random.default_rng(5)
    base = rng.normal(size=(2 * N_SHARD, D)).astype(np.float32)
    query = rng.normal(size=(NQ, D)).astype(np.float32)
    cfg = JGraphConfig.create(N=N_SHARD, D=D, KBuild=KB)
    bases, graphs, indexes = [], [], []
    for i in range(2):
        b = jnp.asarray(base[i * N_SHARD : (i + 1) * N_SHARD])
        graph, _ = j_build_graph(b, cfg, 0.5, refinement_iterations=0,
                                 seed=1234 + i)
        bases.append(b)
        graphs.append(graph)
        indexes.append(j_build_fused_index(b, graph, cfg))
    return {"base": base, "query": query, "cfg": cfg, "mesh": make_mesh(jax.devices()[:2]),
            "j": (bases, graphs, indexes),
            "bases": [torch.from_numpy(base[i * N_SHARD : (i + 1) * N_SHARD])
                      for i in range(2)],
            "graphs": [graph_from_numpy(g) for g in graphs],
            "indexes": [fused_index_from_numpy(x) for x in indexes]}


def _same_rows(a, b):
    return float(np.mean(np.all(np.asarray(a) == np.asarray(b), axis=1)))


def test_sharded_query_matches_jax(shards):
    bases, graphs, _ = shards["j"]
    j_ids, j_d = j_sharded_query(shards["mesh"], stack_shards(bases),
                                 stack_shards(graphs), shards["cfg"],
                                 jnp.asarray(shards["query"]), K, TAU, ITERS,
                                 pops_per_iter=P)
    cfg = GraphConfig.create(N=N_SHARD, D=D, KBuild=KB)
    ids, dists = sharded_query(shards["bases"], shards["graphs"], cfg,
                               torch.from_numpy(shards["query"]), K, TAU, ITERS,
                               pops_per_iter=P)
    assert (ids.numpy() // N_SHARD).max() == 1
    assert _same_rows(ids, j_ids) >= 0.99
    np.testing.assert_allclose(dists.numpy(), np.asarray(j_d), rtol=1e-4, atol=1e-4)


def test_sharded_fused_query_matches_jax(shards):
    bases, _, indexes = shards["j"]
    j_ids, _ = j_sharded_fused_query(shards["mesh"], stack_shards(bases),
                                     stack_shards(indexes),
                                     jnp.asarray(shards["query"]), K, TAU, ITERS,
                                     pops_per_iter=P, num_seeds=8)
    # the rerank and cap the JAX function computes for itself
    width, _ = GraphConfig.query_beam_geometry(K, ITERS)
    cand = int(indexes[0].nbr_ids.shape[1])
    rerank, cap = min(width, max(2 * K, 32)), max(64, P * cand // 4)
    ids, _ = sharded_fused_query(shards["bases"], shards["indexes"],
                                 torch.from_numpy(shards["query"]), K, TAU, ITERS,
                                 pops_per_iter=P, num_seeds=8, rerank=rerank,
                                 cap=cap)
    assert _same_rows(ids, j_ids) >= 0.99


def test_sharded_fused_query_forwards_every_kwarg(shards):
    """The caller's rerank / cap / width reach every shard's walk: the
    result equals the per-shard walks with those values merged, and differs
    from the run with the values the JAX function would impose."""
    q = torch.from_numpy(shards["query"])
    kw = dict(pops_per_iter=P, num_seeds=8, rerank=12, cap=8, width=16)
    ids, dists = sharded_fused_query(shards["bases"], shards["indexes"], q, K,
                                     TAU, ITERS, **kw)
    per_shard = [fused_query(q, x, b, K, TAU, ITERS, **kw)
                 for b, x in zip(shards["bases"], shards["indexes"])]
    want_ids, want_d = merge_over_devices(per_shard, K, N_SHARD)
    assert torch.equal(ids, want_ids) and torch.equal(dists, want_d)
    imposed, _ = sharded_fused_query(shards["bases"], shards["indexes"], q, K,
                                     TAU, ITERS, pops_per_iter=P, num_seeds=8)
    assert not torch.equal(ids, imposed)


def test_sharded_bf_query_matches_jax(shards):
    bases, _, _ = shards["j"]
    k = 20
    j_ids, j_d = j_sharded_bf_query(shards["mesh"], stack_shards(bases),
                                    jnp.asarray(shards["query"]), k)
    ids, dists = sharded_bf_query(shards["bases"],
                                  torch.from_numpy(shards["query"]), k)
    ids, dists, j_ids, j_d = ids.numpy(), dists.numpy(), np.asarray(j_ids), np.asarray(j_d)
    np.testing.assert_allclose(dists, j_d, rtol=1e-5, atol=1e-5)
    base, query = shards["base"].astype(np.float64), shards["query"].astype(np.float64)
    rows, cols = np.nonzero(ids != j_ids)
    mine = np.sum((base[ids[rows, cols]] - query[rows]) ** 2, axis=-1)
    theirs = np.sum((base[j_ids[rows, cols]] - query[rows]) ** 2, axis=-1)
    np.testing.assert_allclose(mine, theirs, rtol=1e-6)
