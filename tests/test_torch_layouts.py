"""The grouped and int4 fused layouts and their sidecars, port against the
JAX package, on one graph the JAX package built (carried across with
``ggnn_torch.convert``).

* Assembly: the port's ``build_fused_index`` for (group, bits) in {(2, 8),
  (4, 8), (1, 4), (2, 4)} equals the JAX index field by field: members,
  group_of, blocks and the neighbour ids bit-equal, norms equal (rtol 1e-6,
  f32 summation order) after unpacking the JAX meta rows.
* ``_code_dists`` on anchors with shared groups and -1: ids equal, distances
  within rtol 1e-5 of the JAX function (``use_pallas=False``).
* Walk parity: the port's ``fused_query`` on the JAX-built group-2 and int4
  indexes reaches the JAX ``fused_query``'s c@1 and c@10 within 0.003
  (``use_pallas=False``, ``seed_approx=False``), ids equal on >= 99% of rows.
* Sidecars: one written by either package loads and validates in the other;
  ``graph_fingerprint`` is equal across the packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ggnn_tpu
from ggnn_tpu.config import DistanceMeasure as JMeasure
from ggnn_tpu.query import fused as jfused
from ggnn_torch import DistanceMeasure, Evaluator
from ggnn_torch.convert import fused_index_from_numpy, graph_from_numpy
from ggnn_torch.query import fused as tfused

N, NQ, D, K = 4096, 1000, 64, 16
LAYOUTS = [(2, 8), (4, 8), (1, 4), (2, 4)]
QKW = dict(num_seeds=8, rerank=16, width=32, cap=32)
TAU, ITERS, P = 0.64, 32, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and beside other test
    processes their spinning costs many times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
def ref():
    base, query = _make_dataset(N, NQ, D)
    jg = ggnn_tpu.GGNN()
    jg.set_base(base)
    jg.build(k_build=K, tau_build=0.5, refinement_iterations=2)
    gt, _ = jg.bf_query(query, k_gt=100)
    shard = jg._shards[0]
    return {"base": base, "query": query, "gt": np.asarray(gt), "cfg": jg._cfg,
            "jgraph": shard.graph, "jbase": shard.base_dev,
            "graph": graph_from_numpy(shard.graph), "indexes": {}}


def _jax_index(ref, group, bits):
    key = (group, bits)
    if key not in ref["indexes"]:
        ref["indexes"][key] = jfused.build_fused_index(
            ref["jbase"], ref["jgraph"], ref["cfg"], group=group, bits=bits)
    return ref["indexes"][key]


def _port_index(ref, group, bits):
    return tfused.build_fused_index(torch.from_numpy(ref["base"]), ref["graph"],
                                    ref["cfg"], group=group, bits=bits)


@pytest.mark.parametrize("group, bits", LAYOUTS)
def test_layout_assembly_equals_reference(ref, group, bits):
    theirs = _jax_index(ref, group, bits)
    mine = _port_index(ref, group, bits)
    assert (mine.group, mine.bits) == (group, bits)
    assert (theirs.group, theirs.bits) == (group, bits)
    for name in ("members", "group_of", "blocks", "scale", "zero", "rep_ids"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      np.asarray(getattr(theirs, name)),
                                      err_msg=name)
    # the JAX meta rows unpacked: ids and norms in the stored column order
    Kc = mine.cand_per_fetch
    H = max(64, -(-Kc // 64) * 64)
    meta = np.asarray(theirs.meta)
    np.testing.assert_array_equal(mine.nbr_ids.numpy(), meta[:, :Kc])
    np.testing.assert_allclose(mine.nbr_sq.numpy(),
                               np.ascontiguousarray(meta[:, H:H + Kc]).view(np.float32),
                               rtol=1e-6)
    # the JAX nbr_ids are member-major; int4 stores even columns, then odd
    member_major = np.asarray(theirs.nbr_ids)
    if bits == 4:
        member_major = np.concatenate([member_major[:, 0::2],
                                       member_major[:, 1::2]], axis=1)
    np.testing.assert_array_equal(mine.nbr_ids.numpy(), member_major)
    # carried across, the JAX index is the port's
    carried = fused_index_from_numpy(theirs)
    for name in ("nbr_ids", "blocks", "group_of", "members"):
        np.testing.assert_array_equal(getattr(carried, name).numpy(),
                                      getattr(mine, name).numpy(), err_msg=name)
    assert tfused.fused_index_matches_graph(mine, ref["graph"], K)


@pytest.mark.parametrize("group, bits, measure", [
    (2, 8, "Euclidean"), (2, 4, "Euclidean"), (4, 8, "Cosine"), (1, 4, "Cosine"),
])
def test_code_dists_equals_reference(ref, group, bits, measure):
    jidx = _jax_index(ref, group, bits)
    index = fused_index_from_numpy(jidx)
    rng = np.random.default_rng(3)
    B, Pp = 256, 8
    anchors = rng.integers(0, N, size=(B, Pp)).astype(np.int32)
    # each row's anchor 1 shares a group with its anchor 0, anchor 3 repeats
    # anchor 2, and a fifth of the slots are empty
    members = jidx.members
    group_of = np.asarray(jidx.group_of)
    m = np.asarray(members)[group_of[anchors[:, 0]]]
    anchors[:, 1] = m[:, -1] if group > 1 else anchors[:, 0]
    anchors[:, 3] = anchors[:, 2]
    anchors[rng.random((B, Pp)) < 0.2] = -1
    q = ref["query"][:B]
    q_sq = np.sum(q * q, axis=-1)
    j_ids, j_d = jfused._code_dists(jnp.asarray(q), jnp.asarray(q_sq),
                                    jnp.asarray(anchors), jidx,
                                    JMeasure[measure], use_pallas=False)
    ids, d = tfused._code_dists(torch.from_numpy(q), torch.from_numpy(q_sq),
                                torch.from_numpy(anchors), index,
                                DistanceMeasure[measure])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    j_d = np.asarray(j_d)
    assert np.array_equal(np.isinf(d.numpy()), np.isinf(j_d))
    fin = np.isfinite(j_d)
    np.testing.assert_allclose(d.numpy()[fin], j_d[fin], rtol=1e-5, atol=1e-6)
    if group > 1:  # where both anchors are live, their group was fetched once
        Kc = index.cand_per_fetch
        both = (anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
        assert both.any()
        assert np.all(ids.numpy()[both, Kc:2 * Kc] == -1)


@pytest.mark.parametrize("group, bits", [(2, 8), (1, 4), (2, 4)])
def test_walk_parity_on_reference_layouts(ref, group, bits, record_property):
    jidx = _jax_index(ref, group, bits)
    base, query = ref["base"], ref["query"]
    j_ids, _ = jfused.fused_query(jnp.asarray(query), jidx, ref["jbase"], 10, TAU,
                                  ITERS, pops_per_iter=P, use_pallas=False,
                                  seed_approx=False, **QKW)
    j_ids = np.asarray(j_ids)
    ids, dists = tfused.fused_query(torch.from_numpy(query),
                                    fused_index_from_numpy(jidx),
                                    torch.from_numpy(base), 10, TAU, ITERS,
                                    pops_per_iter=P, **QKW)
    ids = ids.numpy()
    ev = Evaluator(base, query, ref["gt"], k_query=10)
    mine, theirs = ev.evaluate_results(ids), ev.evaluate_results(j_ids)
    same = float(np.mean(np.all(ids == j_ids, axis=1)))
    record_property("c1", (mine.c1, theirs.c1))
    record_property("same_rows", same)
    print(f"group={group} bits={bits}: port c@1 {mine.c1} c@10 {mine.cKQuery} | "
          f"reference c@1 {theirs.c1} c@10 {theirs.cKQuery} | identical rows {same}")
    assert abs(mine.c1 - theirs.c1) <= 0.003
    assert abs(mine.cKQuery - theirs.cKQuery) <= 0.003
    assert same >= 0.99
    assert np.all(np.diff(dists.numpy(), axis=1) >= 0)


def test_fingerprint_equal_across_packages(ref):
    jgraph = ref["jgraph"]
    np.testing.assert_array_equal(tfused.graph_fingerprint(ref["graph"]),
                                  jfused.graph_fingerprint(jgraph))


@pytest.mark.parametrize("group, bits", [(2, 8), (2, 4)])
def test_sidecars_cross_load(ref, tmp_path, group, bits):
    jgraph, graph = ref["jgraph"], ref["graph"]
    # a port sidecar loads and validates in the JAX package
    mine = _port_index(ref, group, bits)
    tfused.save_fused_index(tmp_path / "port.fused.npz", mine, graph)
    jmeta = jfused.load_fused_index(tmp_path / "port.fused.npz")
    assert jfused.fused_index_matches_graph(jmeta, jgraph, K)
    assert int(jmeta.bits[0]) == bits and jmeta.members.shape[1] == group
    # ... and re-assembles there into the JAX index
    again = jfused.assemble_fused_index(ref["jbase"], jgraph,
                                        members=jmeta.members, scale=jmeta.scale,
                                        zero=jmeta.zero, bits=bits)
    np.testing.assert_array_equal(np.asarray(again.blocks), mine.blocks.numpy())
    # a JAX sidecar loads and validates in the port, and re-assembles there
    jfused.save_fused_index(tmp_path / "jax.fused.npz", _jax_index(ref, group, bits),
                            jgraph)
    meta = tfused.load_fused_index(tmp_path / "jax.fused.npz")
    assert tfused.fused_index_matches_graph(meta, graph, K)
    rebuilt = tfused.assemble_fused_index(
        torch.from_numpy(ref["base"]), graph, members=meta.members,
        scale=meta.scale, zero=meta.zero, bits=int(meta.bits[0]))
    for name in ("nbr_ids", "blocks", "group_of", "members"):
        np.testing.assert_array_equal(getattr(rebuilt, name).numpy(),
                                      getattr(mine, name).numpy(), err_msg=name)
    # another graph's layer 0 does not validate
    other = graph._replace(neighbors=(graph.neighbors[0].flip(0),)
                           + tuple(graph.neighbors[1:]))
    assert not tfused.fused_index_matches_graph(meta, other, K)
    assert not tfused.fused_index_matches_graph(mine, other, K)
