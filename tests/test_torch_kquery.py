"""k_query at the reference's bound of 6000, port against the JAX package.

The JAX package's own envelope test stops at 1000 (``tests/test_envelope.py``
``test_kquery_1000``). Here the port builds 8,192 points and stores them; the
JAX ``GGNN`` loads the same graph and sidecar, so both walk one graph and
one fused index. At k_query=6000 the beam is 6,048 wide and, with a pop
budget of 5,000 (``bit_ceil`` 8,192), the visited cache is clamped at its
8,192 maximum. Each step admits every new neighbour (``cap`` = 32 pops x 12
neighbours), so the budget fills the beam.

* The port's fused rows are sorted, hold no duplicate id, and meet
  ``test_kquery_1000``'s brute-force envelope (more than 0.8 of the exact
  top 6,000); the JAX fused query (``seed_approx=False``) returns the same
  id sets (>= 0.99 per row) and an envelope within 0.003.
* The port's row engine meets the same envelope.
* k_query=6001 raises in both engines.
"""

import numpy as np
import pytest

import ggnn_tpu
from ggnn_torch import GGNN, GraphConfig
from torch_reference import one_torch_thread  # noqa: F401

N, D, K, NQ, KQ = 8192, 8, 12, 4, 6000
BUDGET = 5000
FKW = dict(pops_per_iter=32, cap=32 * K)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    base = rng.normal(size=(N, D)).astype(np.float32)
    query = rng.normal(size=(NQ, D)).astype(np.float32)
    d = tmp_path_factory.mktemp("kquery")
    g = GGNN(device="cpu")
    g.set_base(base)
    g.set_working_directory(d)
    g.build(k_build=K, tau_build=0.5, refinement_iterations=0)
    g.build_fused_index()
    g.store()
    fused = g.query(query, KQ, 1.0, BUDGET, engine="fused",
                    seed_approx=False, **FKW)
    row = g.query(query, KQ, 1.0, BUDGET)
    dist = ((query[:, None] - base[None]) ** 2).sum(-1)
    want = np.argsort(dist, axis=1)[:, :KQ]
    return base, query, d, g, fused, row, want


def _envelope(ids, dists, want):
    """Rows sorted, no duplicate id; the share of the exact top k found."""
    assert ids.shape == (NQ, KQ)
    assert np.all(np.diff(dists, axis=1) >= 0)
    for r in range(NQ):
        valid = ids[r][ids[r] >= 0]
        assert len(np.unique(valid)) == len(valid)
    return float(np.mean([np.isin(ids[r], want[r]).mean() for r in range(NQ)]))


def test_kquery_6000_geometry():
    assert GraphConfig.query_beam_geometry(KQ, BUDGET) == (6048, 8192 - 6048)


def test_kquery_6000_fused_matches_reference(data):
    base, query, d, _, fused, _, want = data
    hit = _envelope(fused.ids, fused.dists, want)
    jg = ggnn_tpu.GGNN()
    jg.set_base(base)
    jg.set_working_directory(d)
    jg.load(K)
    jg.build_fused_index()  # from the port's sidecar
    j_ids, j_d = jg.query(query, KQ, 1.0, BUDGET, engine="fused",
                          seed_approx=False, **FKW)
    j_ids, j_d = np.asarray(j_ids), np.asarray(j_d)
    j_hit = _envelope(j_ids, j_d, want)
    overlap = [len(np.intersect1d(fused.ids[r], j_ids[r])) / KQ
               for r in range(NQ)]
    print(f"k_query {KQ}: port envelope {hit}, reference {j_hit}, id-set "
          f"overlap {overlap}")
    assert hit > 0.8 and abs(hit - j_hit) <= 0.003
    assert min(overlap) >= 0.99


def test_kquery_6000_row_envelope(data):
    _, _, _, _, _, row, want = data
    assert _envelope(row.ids, row.dists, want) > 0.8


@pytest.mark.parametrize("engine", ["row", "fused"])
def test_kquery_above_bound_rejected(data, engine):
    _, query, _, g, _, _, _ = data
    with pytest.raises(ValueError):
        g.query(query, KQ + 1, 1.0, BUDGET, engine=engine)
