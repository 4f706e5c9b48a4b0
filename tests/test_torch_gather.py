"""The walks' fused gather + distance (``ggnn_torch/ops/gather_dist.py``)
against the JAX package's gathers feeding an einsum.

On the CPU the wrapper runs its plain version, held here against the three
JAX sites it replaces, on the same numpy inputs from a seed:
``ggnn_tpu.ops.traverse.gather_dists`` (the row and merge walks), the sym
walk's ``ggnn_tpu.build.sym._pair_dists`` after its gather (Q = 2: the node
and the half-way point) and the fused query's exact re-rank
(``ggnn_tpu/query/fused.py:782``, an expression inside a jitted function,
written out here as it stands there). The cases cover an f32 and a uint8
base, Euclidean and cosine, with and without a translation, -1 ids, K = 1,
D = 128 and 20 (not a multiple of 4: the kernel's scalar path), and D =
256, 960 and 4,096 (the kernel's passes of four 128-dim slabs).
Tolerance: rtol 1e-5 -- XLA's and torch's CPU einsums sum the D products in
their own orders. Base ids are compared exactly.

The kernel (``csrc/gather_dist.cu``) is held against the plain version on
the card only, at the same cases and at the walks' shapes: base ids equal,
distances within ``gather_dist.error_bound`` (the rounding of a sum of D
products in two orders). JAX is imported inside the CPU tests, so that the
card-only tests run where JAX is not installed::

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_gather.py
"""

import numpy as np
import pytest
import torch

from ggnn_torch.config import DistanceMeasure
from ggnn_torch.ops import gather_dist as gd
from ggnn_torch.ops.distance import squared_norms
from ggnn_torch.ops.traverse import gather_dists
from torch_reference import one_torch_thread  # noqa: F401

RTOL = 1e-5
N = 300

# (base dtype, measure, translated, D, K); every case has -1 ids
CASES = [
    ("f32", DistanceMeasure.Euclidean, False, 128, 8),
    ("f32", DistanceMeasure.Cosine, True, 128, 8),
    ("u8", DistanceMeasure.Euclidean, True, 128, 8),
    ("u8", DistanceMeasure.Cosine, False, 20, 8),
    ("f32", DistanceMeasure.Euclidean, True, 20, 1),
    ("u8", DistanceMeasure.Cosine, True, 128, 1),
    # rows wider than one 128-dim slab: the kernel's passes of 4 slabs
    ("f32", DistanceMeasure.Euclidean, False, 256, 8),
    ("u8", DistanceMeasure.Euclidean, True, 960, 8),
    ("f32", DistanceMeasure.Euclidean, False, 960, 16),
    ("f32", DistanceMeasure.Cosine, True, 4096, 8),
]


def case_id(c):
    return f"{c[0]}-{c[1].name}-{'tr' if c[2] else 'notr'}-D{c[3]}-K{c[4]}"


def inputs(dtype, translated, D, K, B=16, Q=1, seed=0):
    """numpy inputs: queries [B, Q, D] f32, ids [B, K] i32 into a layer of
    N // 2 nodes (or N without translation) with ~20% -1, the translation
    [N // 2] i32 or None, the base [N, D] (uint8 range either way) and its
    squared norms; the last base row is zero (a zero norm in cosine)."""
    rng = np.random.default_rng(seed)
    if dtype == "u8":
        base = rng.integers(0, 256, size=(N, D)).astype(np.uint8)
    else:
        base = rng.normal(size=(N, D)).astype(np.float32)
    base[-1] = 0
    qs = rng.normal(size=(B, Q, D)).astype(np.float32)
    if dtype == "u8":
        qs = np.abs(qs) * 64
    n_layer = N // 2 if translated else N
    ids = rng.integers(0, n_layer, size=(B, K)).astype(np.int32)
    ids[rng.random((B, K)) < 0.2] = -1
    ids[0, -1] = n_layer - 1
    translation = None
    if translated:
        translation = rng.permutation(N)[:n_layer].astype(np.int32)
        translation[-1] = N - 1  # the zero row
    base_f = base.astype(np.float32)
    base_sq = np.sum(base_f * base_f, axis=-1).astype(np.float32)
    q_sq = np.sum(qs * qs, axis=-1).astype(np.float32)
    return qs, q_sq, ids, translation, base, base_sq


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_gather_dists_matches_jax(case):
    """``traverse.gather_dists`` (Q = 1) against the JAX package's."""
    import jax.numpy as jnp
    from ggnn_tpu.config import DistanceMeasure as JMeasure
    from ggnn_tpu.ops.traverse import gather_dists as j_gather_dists

    dtype, measure, translated, D, K = case
    qs, q_sq, ids, tr, base, base_sq = inputs(dtype, translated, D, K)
    want_d, want_ids = j_gather_dists(
        jnp.asarray(qs[:, 0]), jnp.asarray(q_sq[:, 0]), jnp.asarray(ids),
        jnp.asarray(base), jnp.asarray(base_sq),
        None if tr is None else jnp.asarray(tr), JMeasure(int(measure)))
    d, base_ids = gather_dists(_t(qs[:, 0]), _t(q_sq[:, 0]), _t(ids), _t(base),
                               _t(base_sq), _t(tr), measure)
    assert d.shape == (16, K) and base_ids.dtype == torch.int64
    np.testing.assert_array_equal(base_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=RTOL)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_pair_dists_match_jax(case):
    """The sym walk's pair distances (Q = 2, one pass over each row) against
    the JAX package's ``_pair_dists`` on its gather (``sym.py:176-179``)."""
    import jax.numpy as jnp
    from ggnn_tpu.build.sym import _pair_dists as j_pair_dists
    from ggnn_tpu.config import DistanceMeasure as JMeasure

    from ggnn_torch.build.sym import _pair_dists

    dtype, measure, translated, D, K = case
    qs, q_sq, ids, tr, base, base_sq = inputs(dtype, translated, D, K, Q=2,
                                              seed=1)
    safe = np.maximum(ids, 0)
    cb = tr[safe] if tr is not None else safe
    vecs = jnp.asarray(base)[jnp.asarray(cb)].astype(jnp.float32)
    want_q, want_h = j_pair_dists(
        jnp.asarray(qs[:, 0]), jnp.asarray(qs[:, 1]), jnp.asarray(q_sq[:, 0]),
        jnp.asarray(q_sq[:, 1]), vecs, jnp.asarray(base_sq)[jnp.asarray(cb)],
        JMeasure(int(measure)))
    dq, dh = _pair_dists(_t(qs), _t(q_sq), _t(ids), _t(base), _t(base_sq),
                         _t(tr), measure)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_q), rtol=RTOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_h), rtol=RTOL)


def _j_rerank(q, q_sq, cand, base, base_sq, measure):
    """The JAX package's re-rank distances (``ggnn_tpu/query/fused.py``
    :780-793), as written there."""
    import jax
    import jax.numpy as jnp

    safe = jnp.clip(cand, 0, None)
    vecs = base[safe].astype(jnp.float32)
    dot = jnp.einsum("bd,brd->br", q, vecs,
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
    if measure == DistanceMeasure.Euclidean:
        d = jnp.maximum(q_sq[:, None] + base_sq[safe] - 2.0 * dot, 0.0)
    else:
        norm_sq = q_sq[:, None] * base_sq[safe]
        okn = norm_sq > 0.0
        d = jnp.abs(1.0 - dot * jax.lax.rsqrt(jnp.where(okn, norm_sq, 1.0)))
        d = jnp.where(okn, d, 1.0)
    return jnp.where(cand == -1, jnp.inf, d)


@pytest.mark.parametrize("case", [c for c in CASES if not c[2]], ids=case_id)
def test_rerank_matches_jax(case):
    """The fused query's re-rank: ``gather_dist`` without translation, then
    the empty slots set to +inf as ``_fused_query_tile`` does."""
    import jax.numpy as jnp

    dtype, measure, _, D, K = case
    qs, q_sq, ids, _, base, base_sq = inputs(dtype, False, D, K, seed=2)
    want = _j_rerank(jnp.asarray(qs[:, 0]), jnp.asarray(q_sq[:, 0]),
                     jnp.asarray(ids), jnp.asarray(base), jnp.asarray(base_sq),
                     measure)
    d, _ = gd.gather_dist(_t(qs), _t(q_sq), _t(ids), _t(base), _t(base_sq),
                          None, measure)
    got = torch.where(_t(ids) == -1, float("inf"), d[:, 0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_cpu_route_is_the_plain_version_and_counts_nothing():
    """On CPU tensors the wrapper is its plain version, bit for bit, and no
    launch is counted; -1 ids read row 0 (through the translation)."""
    qs, q_sq, ids, tr, base, base_sq = inputs("f32", True, 128, 8, Q=2)
    before = gd.launches
    by_variant = gd.variant_launches()
    got = gd.gather_dist(_t(qs), _t(q_sq), _t(ids), _t(base), _t(base_sq),
                         _t(tr))
    want = gd.gather_dist_plain(_t(qs), _t(q_sq), _t(ids), _t(base),
                                _t(base_sq), _t(tr))
    assert gd.launches == before and gd.variant_launches() == by_variant
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].shape == (16, 2, 8)
    assert (got[1][torch.from_numpy(ids) == -1] == int(tr[0])).all()


def test_empty_translation_counts_as_none():
    """Layer 0's translation is an empty tensor: ids are base ids."""
    qs, q_sq, ids, _, base, base_sq = inputs("f32", False, 20, 8)
    a = gd.gather_dist(_t(qs), _t(q_sq), _t(ids), _t(base), _t(base_sq),
                       torch.zeros(0, dtype=torch.int32))
    b = gd.gather_dist(_t(qs), _t(q_sq), _t(ids), _t(base), _t(base_sq), None)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("case", CASES[:4], ids=case_id)
def test_without_ids_the_same_distances(case):
    """``with_ids=False`` (the walks' form): the same distances, no base ids;
    ``traverse.candidate_dists`` is ``gather_dists``' distances."""
    from ggnn_torch.ops.traverse import candidate_dists

    dtype, measure, translated, D, K = case
    qs, q_sq, ids, tr, base, base_sq = inputs(dtype, translated, D, K, Q=2)
    args = (_t(qs), _t(q_sq), _t(ids), _t(base), _t(base_sq), _t(tr), measure)
    d, base_ids = gd.gather_dist(*args)
    d_walk, none = gd.gather_dist(*args, with_ids=False)
    assert none is None and base_ids is not None
    assert torch.equal(d_walk, d)
    one = (_t(qs[:, 0]), _t(q_sq[:, 0]), *args[2:])
    assert torch.equal(candidate_dists(*one), gather_dists(*one)[0])


@pytest.mark.parametrize("translated", [False, True])
def test_an_id_past_the_layer_raises(translated):
    """An id past the layer (or past the translation) raises, as the
    plain route's indexing does; the kernel fails a device assert
    (``test_cuda_an_id_past_the_layer_fails_a_device_assert``)."""
    qs, q_sq, ids, tr, base, base_sq = inputs("f32", translated, 20, 8)
    ids[1, 2] = N // 2 if translated else N
    with pytest.raises(IndexError):
        gd.gather_dist(_t(qs), _t(q_sq), _t(ids), _t(base), _t(base_sq),
                       _t(tr), with_ids=False)


def test_bad_shapes_and_other_device_raise():
    qs, q_sq, ids, _, base, base_sq = inputs("f32", False, 20, 8, Q=2)
    with pytest.raises(ValueError, match="Q of 1 or 2"):
        gd.gather_dist(torch.zeros(4, 3, 20), torch.zeros(4, 3), _t(ids[:4]),
                       _t(base), _t(base_sq))
    with pytest.raises(ValueError, match="shapes"):
        gd.gather_dist(_t(qs), _t(q_sq), _t(ids), _t(base[:, :10]), _t(base_sq))
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gd.gather_dist(_t(qs).to(meta), _t(q_sq).to(meta), _t(ids).to(meta),
                       _t(base).to(meta), _t(base_sq).to(meta))


@pytest.mark.parametrize("Q,D,u8,want", [
    (1, 20, False, (1, 1, False)), (2, 128, True, (2, 1, True)),
    (1, 129, False, (1, 4, False)), (1, 960, False, (1, 4, False)),
    (2, 4096, True, (2, 4, True))])
def test_variant_is_the_launchs_instance(Q, D, u8, want):
    """``variant`` names the instance ``dispatch_ns`` picks: one slab of
    query values up to D = 128, else four a pass."""
    assert gd.variant(Q, D, u8) == want


def test_error_bound():
    """Euclidean: D * 2**-23 * (q_sq + c_sq) per entry; cosine D * 2**-22."""
    q_sq = torch.tensor([[1.0, 2.0]])
    c_sq = torch.tensor([[4.0, 8.0, 16.0]])
    e = gd.error_bound(q_sq, c_sq, 128)
    assert e.shape == (1, 2, 3)
    assert e[0, 1, 2].item() == 128 * 2.0 ** -23 * 18.0
    c = gd.error_bound(q_sq, c_sq, 20, DistanceMeasure.Cosine)
    assert c.shape == (1, 2, 3) and (c == 20 * 2.0 ** -22).all()


def test_smoke_bound_counts_each_byte_once():
    """``chip_smoke.gather_bound``: ids, the distinct translation entries,
    rows and norms read once, the queries and their norms read once, the
    distances written once, and the base ids where they are asked for (the
    walks do not); bound by bytes."""
    import chip_smoke

    ids = torch.tensor([[0, 1, 1], [-1, 2, 0]], dtype=torch.int32)
    tr = torch.tensor([5, 6, 5], dtype=torch.int32)
    nbytes, flops, bound_ms, by = chip_smoke.gather_bound(ids, tr, 128, 4, 2,
                                                          with_ids=True)
    # distinct layer ids {0, 1, 2}; distinct base rows {5, 6}
    want = (2 * 3 * 4 + 3 * 4 + 2 * (128 * 4 + 4) + 2 * 2 * (128 * 4 + 4)
            + 2 * 2 * 3 * 4 + 2 * 3 * 8)
    assert nbytes == want and flops == 2 * 2 * 2 * 3 * 128
    assert by == "bytes" and bound_ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    walk_bytes = chip_smoke.gather_bound(ids, tr, 128, 4, 2)[0]
    assert walk_bytes == want - 2 * 3 * 8


# --- the kernel on the card ------------------------------------------------

# the walks' step shapes (rows B, candidates K, Q, translated) at
# k_build=48, D=128: the row query's step, the f32 merge's (translated),
# the sym walk's (Q = 2), the fused query's re-rank, the merges' own
# distances (one candidate a row, on layer 0 and translated) and the
# descent's seed_beam (S = 32 segment ids a row, translated)
CARD_SHAPES = [(10000, 288, 1, False), (8192, 192, 1, True),
               (32768, 192, 2, False), (8192, 16, 1, False),
               (8192, 1, 1, False), (8192, 1, 1, True), (8192, 32, 1, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def check_on_card(device, qs, q_sq, ids, base, base_sq, tr, measure):
    """Kernel against plain on the card: base ids equal, every distance
    within ``error_bound``. Returns the largest error over its bound."""
    got_d, got_ids = gd.gather_dist(qs, q_sq, ids, base, base_sq, tr, measure)
    walk_d, none = gd.gather_dist(qs, q_sq, ids, base, base_sq, tr, measure,
                                  with_ids=False)
    torch.cuda.synchronize(device)
    assert none is None and torch.equal(walk_d, got_d)
    want_d, want_ids = gd.gather_dist_plain(qs, q_sq, ids, base, base_sq, tr,
                                            measure)
    assert torch.equal(got_ids, want_ids)
    bound = gd.error_bound(q_sq, base_sq[want_ids], qs.shape[2], measure)
    ratio = ((got_d - want_d).abs() / bound).max().item()
    assert ratio <= 1.0, ratio
    return ratio


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_cuda_kernel_matches_plain(cuda_device, case, Q):
    dtype, measure, translated, D, K = case
    arrays = inputs(dtype, translated, D, K, Q=Q, seed=3)
    qs, q_sq, ids, tr, base, base_sq = (None if a is None else
                                        torch.from_numpy(a).to(cuda_device)
                                        for a in arrays)
    before = gd.launches
    check_on_card(cuda_device, qs, q_sq, ids, base, base_sq, tr, measure)
    assert gd.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,Q,translated", CARD_SHAPES)
def test_cuda_kernel_at_the_walks_shapes(cuda_device, B, K, Q, translated):
    """At the walks' shapes over a 262,144 x 128 f32 base (the smoke's), ~10%
    of the ids -1, through a translation where the walk has one."""
    gen = torch.Generator(device=cuda_device).manual_seed(B + K)
    n = 262_144
    base = torch.rand((n, 128), generator=gen, device=cuda_device) * 255.0
    base_sq = squared_norms(base)
    qs = torch.rand((B, Q, 128), generator=gen, device=cuda_device) * 255.0
    q_sq = torch.sum(qs * qs, dim=-1)
    ids = torch.randint(0, n // 2, (B, K), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    ids[torch.rand((B, K), generator=gen, device=cuda_device) < 0.1] = -1
    tr = (torch.randperm(n, generator=gen, device=cuda_device)[: n // 2]
          .to(torch.int32) if translated else None)
    for measure in DistanceMeasure:
        check_on_card(cuda_device, qs, q_sq, ids, base, base_sq, tr, measure)


# the walks' shapes at k_build 24 and D = 960 (the gist1m cell): the fused
# re-rank of a 1,024-row tile (16 candidates), a row step (8 pops x 24), the
# f32 merge's step through a translation, the merges' own distance, the
# descent's seed_beam and the sym walk's step (Q = 2)
WIDE_SHAPES = [(1024, 16, 1, False), (1024, 192, 1, False),
               (8192, 192, 1, True), (8192, 1, 1, False), (8192, 32, 1, True),
               (32768, 192, 2, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,Q,translated", WIDE_SHAPES)
@pytest.mark.parametrize("D", [256, 960, 4096])
def test_cuda_kernel_at_wide_rows(cuda_device, D, B, K, Q, translated):
    """Rows of 256, 960 and 4,096 dims (passes of four 128-dim slabs, the
    last one partial at 960) at the walks' shapes over a 65,536-row base of
    non-negative GIST-like values, ~10% of the ids -1, in both measures:
    base ids equal, distances within ``error_bound``; each launch counts
    under its variant. Rows are cut where the plain version's gathered rows
    would pass 2 GiB."""
    B = min(B, (2 << 30) // (K * D * 4))
    gen = torch.Generator(device=cuda_device).manual_seed(D + B + K)
    n = 65_536
    base = torch.rand((n, D), generator=gen, device=cuda_device) * 0.5
    base_sq = squared_norms(base)
    qs = torch.rand((B, Q, D), generator=gen, device=cuda_device) * 0.5
    q_sq = torch.sum(qs * qs, dim=-1)
    ids = torch.randint(0, n // 2, (B, K), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    ids[torch.rand((B, K), generator=gen, device=cuda_device) < 0.1] = -1
    tr = (torch.randperm(n, generator=gen, device=cuda_device)[: n // 2]
          .to(torch.int32) if translated else None)
    key = gd.variant(Q, D, False)
    before = gd.variant_launches().get(key, 0)
    for measure in DistanceMeasure:
        check_on_card(cuda_device, qs, q_sq, ids, base, base_sq, tr, measure)
    assert key[1] == 4 and gd.variant_launches()[key] == before + 4


@pytest.mark.cuda
def test_cuda_unaligned_base_takes_the_scalar_path(cuda_device):
    """A base view at an odd offset (no 16-byte rows) and a u8 base of D = 20
    are read element by element and agree all the same."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    flat = torch.rand(301 * 128 + 1, generator=gen, device=cuda_device)
    base = flat[1:].view(301, 128)
    qs = torch.rand((64, 1, 128), generator=gen, device=cuda_device)
    ids = torch.randint(-1, 301, (64, 40), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    check_on_card(cuda_device, qs, torch.sum(qs * qs, -1), ids, base,
                  squared_norms(base), None, DistanceMeasure.Euclidean)


@pytest.mark.cuda
def test_cuda_walks_launch_the_kernel(cuda_device):
    """``traverse.gather_dists``, ``traverse.candidate_dists`` (the row
    walk's steps, ``seed_beam`` and the merges' own distances) and the sym
    walk's ``_pair_dists`` on CUDA tensors launch the kernel (no plain route
    on the card)."""
    from ggnn_torch.build.sym import _pair_dists
    from ggnn_torch.ops.traverse import candidate_dists

    qs, q_sq, ids, tr, base, base_sq = (
        None if a is None else torch.from_numpy(a).to(cuda_device)
        for a in inputs("f32", True, 128, 8, Q=2))
    before = gd.launches
    gather_dists(qs[:, 0], q_sq[:, 0], ids, base, base_sq, tr,
                 DistanceMeasure.Euclidean)
    candidate_dists(qs[:, 0], q_sq[:, 0], ids, base, base_sq, tr,
                    DistanceMeasure.Euclidean)
    _pair_dists(qs, q_sq, ids, base, base_sq, tr, DistanceMeasure.Euclidean)
    assert gd.launches == before + 3
    with pytest.raises(ValueError, match="float32 or uint8"):
        gd.gather_dist(qs, q_sq, ids, base.double(), base_sq, tr)


@pytest.mark.cuda
@pytest.mark.parametrize("translated", [False, True])
def test_cuda_an_id_past_the_layer_fails_a_device_assert(cuda_device,
                                                         translated):
    """An id past the layer (or the translation) fails the kernel's device
    assert instead of reading out of bounds. A failed assert leaves the
    process's CUDA context unusable, so the launch runs in a process of its
    own, which must die with the assert."""
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    n_ids = N // 2 if translated else N
    script = textwrap.dedent(f"""
        import torch
        from ggnn_torch.ops import gather_dist as gd
        dev = torch.device("cuda")
        base = torch.rand(({N}, 128), device=dev)
        qs = torch.rand((8, 1, 128), device=dev)
        ids = torch.zeros((8, 4), dtype=torch.int32, device=dev)
        ids[3, 1] = {n_ids}
        tr = (torch.arange({n_ids}, dtype=torch.int32, device=dev)
              if {translated} else None)
        gd.gather_dist(qs, (qs * qs).sum(-1), ids, base, (base * base).sum(-1),
                       tr, with_ids=False)
        torch.cuda.synchronize()
        print("no assert")
    """)
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", script], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "no assert" not in res.stdout
    assert "assert" in res.stderr.lower(), res.stderr[-2000:]
