"""The seeding's approximate top-k (``ggnn_torch/ops/approx_topk.py``)
against ``jax.lax.approx_min_k`` and a numpy model of the TPU's op.

On the CPU, JAX lowers ``approx_min_k`` to its exact fallback, so the
approximation itself is held against a numpy model of its three steps
(reduction size, strided partial reduction into ``M`` bins, exact top-k
of the bin winners by (distance, position)); JAX checks the reduction
size (its ``aggregate_to_topk=False`` width) and the result wherever the
op is exact: ``M == n``, and rows whose exact top-k lie in distinct bins.
At the three seeding shapes the seeds' recall against the exact top-k is
printed and held at >= 0.9 (the op's 0.95 target with margin). The kernel
(``csrc/approx_topk.cu``) is compared with the plain version on the card
only: Euclidean entry for entry (ids equal, distances bit-equal), cosine
ids equal and distances within 2 ulp (``rsqrtf``). JAX is imported inside
the CPU tests, so that the card-only tests run where JAX is not
installed::

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_approx_topk.py
"""

import numpy as np
import pytest
import torch

from ggnn_torch.config import DistanceMeasure
from ggnn_torch.ops import approx_topk
from ggnn_torch.ops.approx_topk import (
    approx_smallest_k,
    approx_smallest_k_plain,
    dist_approx_smallest_k,
    reduction_size,
)
from ggnn_torch.ops.distance import finish, squared_norms

# (n representatives, k seeds) of the seeding at 1,000,000 points: the
# benchmark's num_seeds, the query default, the build merge's
SEEDING = [(30752, 8), (30752, 16), (30752, 32)]
GRID_N = [64, 127, 128, 129, 255, 256, 272, 300, 800, 1208, 1209, 3000,
          12800, 30752, 65536]
GRID_K = [1, 2, 8, 16, 32, 100]
GRID_R = [0.5, 0.9, 0.95, 0.99]


@pytest.mark.parametrize("n", GRID_N)
def test_reduction_size_matches_jax(n):
    """``reduction_size`` equals the width of JAX's ``aggregate_to_topk=False``
    output over the grid of k and recall targets."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((1, n), jnp.float32)
    for k in (k for k in GRID_K if k <= n):
        for r in GRID_R:
            want = jax.lax.approx_min_k(x, k, recall_target=r,
                                        aggregate_to_topk=False)[0].shape[-1]
            assert reduction_size(n, k, r) == want, (n, k, r)


def test_reduction_size_at_the_seeding_shapes():
    assert [reduction_size(n, k) for n, k in SEEDING] == [256, 512, 1024]
    assert reduction_size(30752, 8) % 128 == 0
    assert reduction_size(100, 8) == 100 and reduction_size(272, 8) == 256


def _model(d, k, r=0.95):
    """numpy model of the op: bins of c mod M, each bin's smallest
    (distance, position), the k smallest winners by (distance, position);
    a NaN counts as +inf."""
    d = np.where(np.isnan(d), np.float32(np.inf), d)
    B, n = d.shape
    M = reduction_size(n, k, r)
    if k > M:
        M = n
    out_d = np.empty((B, k), np.float32)
    out_p = np.empty((B, k), np.int64)
    for b in range(B):
        wins = []
        for j in range(M):
            pos = np.arange(j, n, M)
            vals = d[b, pos]
            t = int(np.lexsort((pos, vals))[0])
            wins.append((vals[t], pos[t]))
        wins.sort()
        out_d[b] = [w[0] for w in wins[:k]]
        out_p[b] = [w[1] for w in wins[:k]]
    return out_d, out_p


def _dists(B, n, seed, ties=False):
    rng = np.random.default_rng(seed)
    d = rng.random((B, n), dtype=np.float32)
    if ties:  # few distinct values: ties inside bins and across bins
        d = np.floor(d * 16).astype(np.float32)
    return d


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n, k", [(100, 8), (300, 8), (800, 16), (1209, 32),
                                  (3000, 32), (2000, 3), (500, 1)])
def test_plain_matches_numpy_model(n, k, ties):
    d = _dists(6, n, n + k, ties)
    want_d, want_p = _model(d, k)
    got_d, got_p = approx_smallest_k_plain(torch.from_numpy(d), k)
    assert got_p.dtype == torch.int32 and got_d.shape == (6, k)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_d.numpy(), want_d)


@pytest.mark.parametrize("n, k", [(300, 8), (3000, 32), (100, 8)])
def test_plain_counts_nan_as_inf(n, k):
    """NaN distances (a NaN representative's column, and whole rows of NaN)
    order as +inf, as in the kernel: the plain version equals the model and
    returns no NaN."""
    d = _dists(6, n, 5 * n + k)
    d[:, 3] = np.nan  # a representative with a NaN coordinate
    d[:, n // 2:] = np.where(np.arange(n - n // 2) % 7 == 0, np.nan,
                             d[:, n // 2:])
    d[1] = np.nan
    want_d, want_p = _model(d, k)
    got_d, got_p = approx_smallest_k_plain(torch.from_numpy(d), k)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    assert not got_d.isnan().any() and 3 not in got_p[0].tolist()
    assert got_d[1].isinf().all()


@pytest.mark.parametrize("n, k", [(64, 8), (128, 16), (250, 8), (1000, 32)])
def test_plain_equals_jax_where_no_reduction(n, k):
    """``M == n``: the op is the exact top-k, as JAX's fallback gives it."""
    import jax
    import jax.numpy as jnp

    assert reduction_size(n, k) == n
    d = _dists(8, n, 7 * n + k)
    want_d, want_p = jax.lax.approx_min_k(jnp.asarray(d), k)
    got_d, got_p = approx_smallest_k_plain(torch.from_numpy(d), k)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("n, k", [(800, 8), (3000, 16), (30752, 8)])
def test_plain_equals_jax_on_rows_of_distinct_bins(n, k):
    """Where no two of a row's exact top-k share a bin, every one of them
    wins its bin, so the op equals JAX's exact fallback on that row."""
    import jax
    import jax.numpy as jnp

    M = reduction_size(n, k)
    assert M < n
    d = _dists(64, n, 11 * n + k)
    want_d, want_p = (np.asarray(x) for x in jax.lax.approx_min_k(jnp.asarray(d), k))
    got_d, got_p = (x.numpy() for x in approx_smallest_k_plain(torch.from_numpy(d), k))
    distinct = np.array([len(set(row % M)) == k for row in want_p])
    assert distinct.sum() >= 8
    np.testing.assert_array_equal(got_p[distinct], want_p[distinct])
    np.testing.assert_array_equal(got_d[distinct], want_d[distinct])
    # elsewhere only the set may differ, never the order
    assert np.all(np.diff(got_d, axis=1) >= 0)


@pytest.mark.parametrize("n, k", SEEDING)
def test_recall_at_the_seeding_shapes(n, k):
    """The seeds' recall against the exact top-k on distances of a dense
    scan (gaussian points, D=32): at least 0.9."""
    rng = np.random.default_rng(k)
    q = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32))
    q_sq, c_sq = squared_norms(q), squared_norms(c)
    _, pos = dist_approx_smallest_k(q, c, k, q_sq=q_sq, c_sq=c_sq)
    exact = torch.topk(finish(q @ c.T, q_sq[:, None], c_sq[None, :],
                              DistanceMeasure.Euclidean), k, largest=False).indices
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(pos, exact))
    recall = hits / exact.numel()
    print(f"approx top-k recall at n={n}, k={k} (M={reduction_size(n, k)}): "
          f"{recall:.4f}")
    assert recall >= 0.9


@pytest.mark.parametrize("measure", list(DistanceMeasure))
def test_entry_point_is_finish_then_plain(measure, monkeypatch):
    """On the CPU the entry point is ``finish`` and the plain version, and
    launches nothing."""
    monkeypatch.setattr(approx_topk, "launches", 0)
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(20, 16)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(700, 16)).astype(np.float32))
    q[0] = 0  # a zero norm: cosine distance 1
    q_sq, c_sq = squared_norms(q), squared_norms(c)
    got = dist_approx_smallest_k(q, c, 16, measure, q_sq=q_sq, c_sq=c_sq)
    want = approx_smallest_k_plain(finish(q @ c.T, q_sq[:, None], c_sq[None, :],
                                          measure), 16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert approx_topk.launches == 0


@pytest.mark.parametrize("kind", ["f64 dot", "strided row", "norms",
                                  "shared memory"])
def test_kernel_route_refuses_what_it_cannot_take(kind):
    """The checks that run before a launch raise (reached through the
    kernel route's own entry, which checks before it touches a device)."""
    B, n = 4, 1000
    dot, q_sq, c_sq = torch.zeros(B, n), torch.zeros(B), torch.zeros(n)
    k = 8
    if kind == "f64 dot":
        dot = dot.double()
    elif kind == "strided row":
        dot = torch.zeros(B, 2 * n)[:, ::2]
    elif kind == "norms":
        c_sq = torch.zeros(n + 1)
    elif kind == "shared memory":  # exact at k=2000: 40,000 bins
        n, k = 40_000, 2000
        dot, c_sq = torch.zeros(B, n), torch.zeros(n)
    with pytest.raises(ValueError, match="approx top-k kernel"):
        approx_topk._launch(dot, q_sq, c_sq, k, DistanceMeasure.Euclidean)


@pytest.mark.parametrize("n, k, rb", [(30752, 8, 2), (30752, 16, 4),
                                      (30752, 32, 8), (100, 8, 1),
                                      (3000, 100, 8), (1000, 32, 8),
                                      (129, 1, 1), (640, 32, 8)])
def test_kernel_layout(n, k, rb):
    """The kernel's per-row layout (mirrored from ``csrc/approx_topk.cu``):
    a thread's bins in registers a pass (the template argument), the bins
    in shared memory, and bins a multiple of the 128 lanes wherever they
    reduce."""
    M = reduction_size(n, k)
    bins = n if k > M else M
    assert approx_topk.bins_per_pass(n, k) == rb
    assert rb * 128 >= min(bins, 8 * 128)
    assert approx_topk.shared_bytes(n, k) == 8 * bins <= approx_topk.MAX_SHARED_BYTES
    assert bins == n or bins % 128 == 0


def test_smoke_bound_counts_each_byte_once():
    """``chip_smoke.approx_bound``: the dot matrix and both norms read once,
    the [B, k] distances and positions written once; bound by bytes."""
    import chip_smoke

    nbytes, bound_ms, by = chip_smoke.approx_bound(8192, 30752, 8)
    assert nbytes == 8192 * 30752 * 4 + 30752 * 4 + 8192 * 4 + 8192 * 8 * 8
    assert by == "bytes" and bound_ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_bad_k_and_other_device_raise():
    with pytest.raises(ValueError, match="outside"):
        approx_smallest_k_plain(torch.zeros(2, 10), 11)
    meta = torch.zeros(2, 300, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        approx_smallest_k(meta, torch.zeros(2, device="meta"),
                          torch.zeros(300, device="meta"), 8)


# --- the kernel on the card ------------------------------------------------

# (B rows, n, k, rows that are queries): the seeding's tiles at 1,000,000
# points (the benchmark's k and the merge's), the last tile of 50,000
# queries padded with zero rows, a row shorter than 128 (no reduction) and
# an exact row of more than 8 bins a thread (passes)
CARD_SHAPES = [(8192, 30752, 8, 8192), (8192, 30752, 32, 8192),
               (1024, 30752, 8, 848), (512, 100, 8, 512), (64, 3000, 100, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_inputs(device, B, n, rows, measure=DistanceMeasure.Euclidean, seed=0):
    """The seeding's inputs on the card: query rows and representatives at
    the data's magnitudes (uint8 range), the query rows past ``rows`` zero
    (a padded tile); returns (dot, q_sq, c_sq)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.rand((B, 128), generator=gen, device=device) * 255.0
    q[rows:] = 0
    c = torch.rand((n, 128), generator=gen, device=device) * 255.0
    if measure == DistanceMeasure.Cosine:
        c[0] = 0  # a zero norm: distance 1
    return q @ c.T, squared_norms(q), squared_norms(c)


@pytest.mark.cuda
@pytest.mark.parametrize("B, n, k, rows", CARD_SHAPES)
def test_cuda_kernel_matches_plain_euclidean(cuda_device, B, n, k, rows):
    dot, q_sq, c_sq = card_inputs(cuda_device, B, n, rows)
    before = approx_topk.launches
    d, p = approx_smallest_k(dot, q_sq, c_sq, k)
    torch.cuda.synchronize()
    assert approx_topk.launches == before + 1
    want_d, want_p = approx_smallest_k_plain(
        finish(dot, q_sq[:, None], c_sq[None, :], DistanceMeasure.Euclidean), k)
    assert torch.equal(p, want_p)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B, n, k, rows", CARD_SHAPES[1:4])
def test_cuda_kernel_matches_plain_cosine(cuda_device, B, n, k, rows):
    dot, q_sq, c_sq = card_inputs(cuda_device, B, n, rows, DistanceMeasure.Cosine)
    d, p = approx_smallest_k(dot, q_sq, c_sq, k, DistanceMeasure.Cosine)
    torch.cuda.synchronize()
    want_d, want_p = approx_smallest_k_plain(
        finish(dot, q_sq[:, None], c_sq[None, :], DistanceMeasure.Cosine), k)
    assert torch.equal(p, want_p)
    ulp = (d.view(torch.int32).long() - want_d.view(torch.int32).long()).abs()
    assert int(ulp.max()) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("measure", list(DistanceMeasure))
def test_cuda_kernel_counts_nan_as_inf(cuda_device, measure):
    """A representative with a NaN coordinate and a query row of NaN: the
    kernel orders their NaN distances as +inf, as the plain version does
    (cosine: ``finish`` makes a NaN norm's distance 1 on both sides)."""
    B, n, k = 256, 30752, 8
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.rand((B, 128), generator=gen, device=cuda_device) * 255.0
    c = torch.rand((n, 128), generator=gen, device=cuda_device) * 255.0
    c[5, 0] = float("nan")
    q[1, 0] = float("nan")
    dot, q_sq, c_sq = q @ c.T, squared_norms(q), squared_norms(c)
    d, p = approx_smallest_k(dot, q_sq, c_sq, k, measure)
    want_d, want_p = approx_smallest_k_plain(
        finish(dot, q_sq[:, None], c_sq[None, :], measure), k)
    assert torch.equal(p, want_p) and not d.isnan().any()
    ulp = (d.view(torch.int32).long() - want_d.view(torch.int32).long()).abs()
    assert int(ulp.max()) <= (0 if measure == DistanceMeasure.Euclidean else 2)
    nan_row = float("inf") if measure == DistanceMeasure.Euclidean else 1.0
    assert (d[1] == nan_row).all()
    assert not (torch.cat([p[:1], p[2:]]) == 5).any()


@pytest.mark.cuda
def test_cuda_entry_point_matches_plain(cuda_device):
    """``dist_approx_smallest_k`` on the card against the CPU's route on the
    same dot products' inputs: the same seeds (the products differ only in
    summation order, so ties aside the ids agree)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.rand((256, 128), generator=gen, device=cuda_device) * 255.0
    c = torch.rand((5000, 128), generator=gen, device=cuda_device) * 255.0
    q_sq, c_sq = squared_norms(q), squared_norms(c)
    _, p = dist_approx_smallest_k(q, c, 16, q_sq=q_sq, c_sq=c_sq)
    _, want = dist_approx_smallest_k(q.cpu(), c.cpu(), 16, q_sq=q_sq.cpu(),
                                     c_sq=c_sq.cpu())
    same = (p.cpu() == want).all(dim=1).float().mean().item()
    assert same >= 0.99
