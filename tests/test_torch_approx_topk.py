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
from torch_reference import one_torch_thread  # noqa: F401

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


# (n, k) -> (kernel, rows per block, lanes per row, bins a lane a pass,
# passes, tiles a batch): the seeding's three shapes, k = 1, bins not a power
# of two times 128 (640: 5 sub-tiles), more than 1,024 bins (1,280: two
# passes), the exact rows (n below 128, k > M, the k_query shape with passes)
# and k above 32
LAYOUTS = [
    ((30752, 8), ("warp", 4, 32, 8, 1, 4)),
    ((30752, 16), ("warp", 4, 32, 16, 1, 2)),
    ((30752, 32), ("warp", 4, 32, 32, 1, 1)),
    ((129, 1), ("warp", 4, 32, 4, 1, 8)),
    ((1208, 32), ("warp", 4, 32, 32, 1, 1)),
    ((2400, 32), ("warp", 4, 32, 32, 2, 1)),
    ((800, 16), ("warp", 4, 32, 16, 1, 2)),
    ((100, 8), ("block", 1, 128, 1, 1, 1)),
    ((1000, 32), ("block", 1, 128, 8, 1, 1)),
    ((3000, 100), ("block", 1, 128, 8, 3, 1)),
    ((30752, 100), ("block", 1, 128, 8, 4, 1)),
]


@pytest.mark.parametrize("nk, want", LAYOUTS)
def test_kernel_layout(nk, want):
    """The launcher's choice and layout (mirrored from
    ``csrc/approx_topk.cu``): the warp kernel for reducing rows at k <= 32,
    4 rows a block of 32 lanes each, a lane's 4 bins of each sub-tile in
    registers, every bin covered, a stage of ``BATCH`` 16-byte pieces a
    lane, its ring in shared memory; unaligned rows and the rest take the
    block kernel, its winners in shared memory; both within
    ``MAX_SHARED_BYTES``; bins a multiple of 128 wherever they reduce."""
    n, k = nk
    M = reduction_size(n, k)
    bins = n if k > M else M
    lay = approx_topk.kernel_layout(n, k)
    assert (lay.kernel, lay.rows_per_block, lay.lanes_per_row, lay.bins_per_lane,
            lay.passes, lay.tiles_per_batch) == want
    assert lay.bins_per_lane * lay.lanes_per_row * lay.passes >= bins
    assert lay.shared_bytes <= approx_topk.MAX_SHARED_BYTES
    assert lay.rows_per_block * lay.lanes_per_row == approx_topk.THREADS
    if lay.kernel == "warp":
        assert bins < n and bins % 128 == 0 and k <= 32
        assert lay.shared_bytes == approx_topk.RING_BYTES == 40960
        assert lay.tiles_per_batch * lay.bins_per_lane // 4 == approx_topk.BATCH
        nsub = lay.bins_per_lane // 4
        assert lay.template == f"approx_topk_kernel_warpILi{nsub}ELi0EE"
        cos = approx_topk.kernel_layout(n, k, measure=DistanceMeasure.Cosine)
        assert cos.template == f"approx_topk_kernel_warpILi{nsub}ELi1EE"
        unaligned = approx_topk.kernel_layout(n, k, aligned=False)
        assert unaligned.kernel == "block" and unaligned.shared_bytes == 8 * bins
    else:
        assert bins == n or k > 32
        assert lay.shared_bytes == 8 * bins
        assert lay.template == f"approx_topk_kernel_blockILi{lay.bins_per_lane}EE"


# distances the key map must order: both infinities, signed zeros, a
# denormal, negatives, NaN
KEY_VALUES = np.array([-np.inf, -3.5, -1e-45, -0.0, 0.0, 1e-45, 1e-30, 0.25,
                       1.0, 7.0, 3e38, np.inf, np.nan], np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_order_keys_order_as_distance_then_position(seed):
    """Sorting by the 64-bit key is sorting by (distance, position) with
    NaN as +inf and -0.0 equal to 0.0 -- the plain route's order (a numpy
    lexsort on the same pairs)."""
    rng = np.random.default_rng(seed)
    d = rng.choice(KEY_VALUES, size=400)
    pos = rng.permutation(1 << 20)[:400].astype(np.int64)
    pos[:3] = [0, (1 << 31) - 1, 1 << 30]
    keys = approx_topk.order_keys(torch.from_numpy(d), torch.from_numpy(pos))
    assert keys.dtype == torch.int64
    clean = np.where(np.isnan(d), np.float32(np.inf), d) + np.float32(0.0)
    want = np.lexsort((pos, clean))
    np.testing.assert_array_equal(np.argsort(keys.numpy(), kind="stable"), want)


def test_order_keys_nan_is_inf_and_zeros_are_equal():
    d = torch.tensor([np.nan, np.inf, -0.0, 0.0, -np.nan], dtype=torch.float32)
    k = approx_topk.order_keys(d, torch.full((5,), 17)).tolist()
    assert k[0] == k[1] == k[4] and k[2] == k[3] == 17
    # below +inf at any position, above every finite distance
    assert approx_topk.order_keys(torch.tensor([3e38]), torch.tensor([2**31 - 1])) < k[1]


def test_seeding_product_on_the_cpu_is_the_plain_product():
    """On the CPU the seeding's product is ``q @ c.T`` in f32, contiguous
    (the padded row stride is for the card's bulk copies)."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32))
    c = torch.from_numpy(rng.integers(0, 255, size=(31, 5)).astype(np.uint8))
    dot = approx_topk.seeding_product(q, c)
    assert dot.is_contiguous() and dot.dtype == torch.float32
    assert torch.equal(dot, q @ c.float().T)


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


# (B, n, k, rows): B not a multiple of the 4 rows a block (the build's
# ragged last chunk, a tile of 1,000), n whose last tile is short (30,752
# at 1,024 bins ends in 32 columns; 1,000 at k = 32 is exact), 5 sub-tiles
# (640 bins), two passes (1,280 bins), k = 1
EDGE_SHAPES = [(8191, 30752, 32, 8191), (1000, 30752, 8, 1000),
               (1000, 30752, 16, 1000), (512, 1000, 32, 512),
               (300, 1208, 32, 300), (300, 2400, 32, 300), (300, 30752, 1, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("B, n, k, rows", EDGE_SHAPES)
def test_cuda_kernel_edges(cuda_device, B, n, k, rows):
    dot, q_sq, c_sq = card_inputs(cuda_device, B, n, rows, seed=B + n + k)
    d, p = approx_smallest_k(dot, q_sq, c_sq, k)
    torch.cuda.synchronize()
    want_d, want_p = approx_smallest_k_plain(
        finish(dot, q_sq[:, None], c_sq[None, :], DistanceMeasure.Euclidean), k)
    assert torch.equal(p, want_p)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [30751, 30752])
def test_cuda_kernel_unaligned_rows(cuda_device, n):
    """Rows at a stride that is not a multiple of 4 elements, and norms at
    an odd offset: the block kernel and the warp kernel (the norms copied
    to an aligned buffer) give the plain version's result."""
    B, k = 777, 32
    dot, q_sq, c_sq = card_inputs(cuda_device, B, n, B, seed=n)
    want_d, want_p = approx_smallest_k_plain(
        finish(dot, q_sq[:, None], c_sq[None, :], DistanceMeasure.Euclidean), k)
    strided = torch.empty((B, n + 1), device=cuda_device)[:, :n]
    strided.copy_(dot)
    odd = torch.empty(n + 1, device=cuda_device)[1:]
    odd.copy_(c_sq)
    for a, b in ((strided, c_sq), (dot, odd)):
        d, p = approx_smallest_k(a, q_sq, b, k)
        assert torch.equal(p, want_p)
        assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [30749, 30750, 30751])
def test_cuda_seeding_product_aligns_rows(cuda_device, n):
    """``n % 4 != 0``: the product's rows sit at a stride rounded up to 4
    (the warp kernel's bulk copies), its values are the plain product's,
    and the seeding through it equals the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    q = torch.rand((300, 128), generator=gen, device=cuda_device) * 255.0
    c = torch.rand((n, 128), generator=gen, device=cuda_device) * 255.0
    dot = approx_topk.seeding_product(q, c)
    assert dot.shape == (300, n) and dot.stride() == (-(-n // 4) * 4, 1)
    # cuBLAS may sum in another order at another row stride
    assert torch.allclose(dot, q @ c.T, rtol=1e-5, atol=0.0)
    q_sq, c_sq = squared_norms(q), squared_norms(c)
    d, p = dist_approx_smallest_k(q, c, 8, q_sq=q_sq, c_sq=c_sq)
    want_d, want_p = approx_smallest_k_plain(
        finish(dot, q_sq[:, None], c_sq[None, :], DistanceMeasure.Euclidean), 8)
    assert torch.equal(p, want_p)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32])
def test_cuda_kernel_equal_distances_across_bins(cuda_device, k):
    """Few distinct distances: ties inside bins and across bins, every one
    broken by position, as in the plain version."""
    B, n = 1024, 30752
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    dot = -torch.randint(0, 6, (B, n), generator=gen, device=cuda_device).float()
    q_sq = torch.zeros(B, device=cuda_device)
    c_sq = torch.zeros(n, device=cuda_device)
    d, p = approx_smallest_k(dot, q_sq, c_sq, k)
    want_d, want_p = approx_smallest_k_plain(
        finish(dot, q_sq[:, None], c_sq[None, :], DistanceMeasure.Euclidean), k)
    assert torch.equal(p, want_p)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32])
def test_cuda_kernel_nan_rows(cuda_device, k):
    """Rows of NaN products (every bin at +inf, its first position) and
    rows with NaN stripes, at the seeding's widths."""
    B, n = 64, 30752
    dot, q_sq, c_sq = card_inputs(cuda_device, B, n, B, seed=k)
    dot[3] = float("nan")
    dot[5, ::7] = float("nan")
    d, p = approx_smallest_k(dot, q_sq, c_sq, k)
    want_d, want_p = approx_smallest_k_plain(
        finish(dot, q_sq[:, None], c_sq[None, :], DistanceMeasure.Euclidean), k)
    assert torch.equal(p, want_p)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))
    assert d[3].isinf().all() and p[3].tolist() == list(range(k))


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
