"""The port's build options against the JAX package's: the exact f32-fetch
build (asked for, or the automatic fallback), the hierarchic-descent merge
with the walking sym pass, and the lazily fitted quantizer.

End to end, both packages build the same data with the same options and
query it with the default (row) engine. The builds draw their layer
selections from different random streams (``torch.Generator`` vs
``jax.random``; ``tests/test_torch_slice.py`` explains why), so their graphs
differ like two seeds of one package do: c@1 is held within 0.01 at points
where the walk, not the seed, decides recall.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ggnn_tpu
from ggnn_tpu.build.construction import _BuildContext as JBuildContext
from ggnn_tpu.config import GraphConfig as JGraphConfig
from ggnn_torch import GGNN, DistanceMeasure, Evaluator, GraphConfig
from ggnn_torch.build.construction import _BuildContext, quantized_fetch_fits

N, NQ, D, K = 4096, 1000, 64, 16
# (tau_query, pop budget): a mid and an easy point of the row engine
POINTS = [(0.45, 32), (0.5, 64)]
MODES = {
    "f32": dict(quantized_fetch=False),
    "descent_walk": dict(dense_seed_merge=False, sym_mode="walk"),
}


def _make_dataset(n, nq, d, d_latent=12, seed=0):
    """SIFT-like synthetic vectors (the benchmark's generator, scaled down)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d_latent, d)).astype(np.float32) / np.sqrt(d_latent)

    def sample(m):
        z = rng.normal(size=(m, d_latent)).astype(np.float32)
        x = z @ w * 40.0 + 128.0 + rng.normal(0, 4, size=(m, d)).astype(np.float32)
        return np.clip(x, 0, 255).astype(np.float32)

    return sample(n), sample(nq)


@pytest.fixture(scope="module")
def data():
    return _make_dataset(N, NQ, D)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_end_to_end_build_modes(data, mode, record_property):
    base, query = data
    jg = ggnn_tpu.GGNN()
    jg.set_base(base)
    jg.build(k_build=K, tau_build=0.5, refinement_iterations=2, **MODES[mode])
    gt, _ = jg.bf_query(query, k_gt=100)
    evaluator = Evaluator(base, query, np.asarray(gt), k_query=10)
    g = GGNN(device="cpu")
    g.set_base(base)
    g.build(k_build=K, tau_build=0.5, refinement_iterations=2, **MODES[mode])
    phases = g.last_build_stats["shards"][0]["phases"]
    if mode == "f32":
        # no quantized walk: no quantizer fit and no adjacency inlined
        assert not any(p.startswith(("quantize", "adj")) for p in phases)
        assert g._shards[0].quantizer is None
    else:
        assert any(p.startswith("adj") for p in phases)
        sym = g.last_build_stats["shards"][0]["sym"]
        assert sum(s["walk_rows"] for s in sym) > 0
    for tau, iters in POINTS:
        ids, dists = g.query(query, 10, tau, iters)
        assert np.all(np.diff(dists, axis=1) >= 0)
        j_ids, _ = jg.query(query, 10, tau, iters)
        c1 = evaluator.evaluate_results(ids).c1
        jc1 = evaluator.evaluate_results(np.asarray(j_ids)).c1
        record_property(f"c1_{tau}_{iters}", (c1, jc1))
        print(f"{mode} tau={tau} iters={iters}: port c@1 {c1} | reference {jc1}")
        assert abs(c1 - jc1) <= 0.01
    # the f32 build's graph still derives a fused index (fitting its own
    # quantizer) and the fused engine runs on it
    g.build_fused_index()
    ids, _ = g.query(query[:100], 10, 0.5, 32, engine="fused")
    assert ids.shape == (100, 10) and np.all(ids >= 0)


def _heavy_tailed(rng):
    data = rng.random((1024, 32)).astype(np.float32)
    bad = data.copy()
    bad[:, 0] *= 1e6  # one heavy-tailed dimension
    return data, bad


def test_quantizer_guard_falls_back_on_heavy_tails():
    """A single outlier dimension disables the u8 walk metric, as in the
    JAX package (``tests/test_build.py``)."""
    data, bad = _heavy_tailed(np.random.default_rng(0))
    cfg = GraphConfig.create(1024, 32, 12)
    E = DistanceMeasure.Euclidean
    ctx = _BuildContext(torch.from_numpy(data), cfg, E, 0.5, 1234, 1024)
    ctx.nn1_stats = torch.tensor([0.5, 1.0])
    ctx._ensure_codes()
    assert ctx._quant_usable()  # well-conditioned data passes
    ctx2 = _BuildContext(torch.from_numpy(bad), cfg, E, 0.5, 1234, 1024)
    ctx2.nn1_stats = torch.tensor([0.5, 1.0])
    ctx2._ensure_codes()
    assert not ctx2._quant_usable()  # dequantization error >> 1-NN distance
    # the reference decides the same on the same data
    for x, want in ((data, True), (bad, False)):
        jctx = JBuildContext(jnp.asarray(x), cfg, E, 0.5, 1234, 1024)
        jctx.nn1_stats = jnp.asarray([0.5, 1.0], jnp.float32)
        jctx._ensure_codes()
        assert jctx._quant_usable() == want


def test_quantizer_guard_build_completes_on_f32_fetches(caplog):
    """A base whose 1-NN scale is below the u8 quantization step (tight
    clusters, contiguous in id order, on a wide range): the guard trips at
    the first merge, the build says so, walks exact f32 rows and completes
    with a usable graph."""
    rng = np.random.default_rng(1)
    centers = rng.random((8, 32)).astype(np.float32) * 100
    base = (np.repeat(centers, 128, 0)
            + rng.normal(0, 0.1, (1024, 32))).astype(np.float32)
    g = GGNN(device="cpu")
    g.set_base(base)
    g.build(k_build=12, tau_build=0.5, refinement_iterations=1)
    phases = g.last_build_stats["shards"][0]["phases"]
    assert not any(p.startswith("adj") for p in phases)  # no quantized walk
    assert "quantized fetch disabled" in caplog.text
    nbrs = g.get_graph().neighbors[0].numpy()
    assert nbrs.shape == (1024, 12) and np.all((nbrs >= 0) & (nbrs < 1024))
    gt, _ = g.bf_query(base, k_gt=7)
    hits = np.mean([np.isin(nbrs[i, :6], gt[i, 1:]).mean() for i in range(1024)])
    assert hits > 0.8, hits
    ids, _ = g.query(base[::16], 5, 0.5, 64)
    assert np.mean(ids[:, 0] == np.arange(0, 1024, 16)) >= 0.95


@pytest.mark.parametrize("n", [1_048_576, 1_100_000])
def test_inline_adjacency_bound_matches_reference(n):
    """The automatic f32 fallback above 6 GiB of inline adjacency (k=48,
    D=128): the port's decision equals the JAX package's expression
    (``ggnn_tpu/build/construction.py``), decided from the geometry alone."""
    cfg = GraphConfig.create(N=n, D=128, KBuild=48)
    jcfg = JGraphConfig.create(N=n, D=128, KBuild=48)
    assert quantized_fetch_fits(cfg) == (jcfg.N * jcfg.KBuild * jcfg.D <= 6 << 30)
    assert quantized_fetch_fits(cfg) == (n <= 1_048_576)
