"""The beam's id dedup and compaction against the JAX package's.

``beam_dedup_mask_plain`` and ``beam_compact_candidates_plain`` (the CPU
route and the oracle of ``csrc/beam_dedup.cu``) are held exactly against
``ggnn_tpu.ops.beam.beam_dedup_mask`` and ``beam_compact_candidates`` on
the same numpy inputs, at each walk's shape family cut to a few rows:
heavy duplication inside a tile, candidates already in the beam or the
visited ring, -1 candidates and ring entries, with and without ``valid``;
and at adversarial cases of the kernel's hash table (``ADVERSARIAL``: ids
that collide in a power-of-two table, a duplicate whose first occurrence
is invalid, rows of all -1, rows whose every candidate is in the ring,
seen lists mostly -1) for K in {1, 31, 33, 97}, each compacted to a cap
below, at and above its survivors. The kernel itself is compared with the
plain version on the card only (0 differing entries) at the same cases,
also replayed from a CUDA graph; the JAX package is imported inside the
CPU tests, so that the card-only tests run where JAX is not installed::

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_dedup.py
"""

import numpy as np
import pytest
import torch

from ggnn_torch.ops import beam
from ggnn_torch.ops.beam import (
    BeamState,
    beam_compact_candidates_plain,
    beam_dedup_compact,
    beam_dedup_mask,
    beam_dedup_mask_plain,
)
from torch_reference import one_torch_thread  # noqa: F401

# (caller, K candidates, W beam, V ring), cut to a few rows below; k=48,
# P=8 as ggnn_torch/config.py gives them
SHAPES = {
    "fused query step": (32, 32, 32),
    "quantized merge step": (96, 96, 160),
    "row query step": (384, 64, 192),  # K > W + V
    "f32 merge step": (384, 96, 160),
    "sym walk step": (96, 64, 64),
    "seeding": (8, 32, 32),  # K < W + V
    "k_query 6000 (cut)": (96, 600, 200),
}


def _inputs(seed, B, K, W, V):
    """A beam state and a candidate tile: ids from a range about K wide
    (so many repeat inside the tile), a quarter of the tile copied from the
    beam and from the ring, ~10% -1 candidates, empty beam slots and ring
    entries, and a ~90% ``valid`` mask."""
    rng = np.random.default_rng(seed)
    n_ids = max(8, K)
    pool = max(4 * n_ids, 2 * W)  # ids the beam and the ring draw from
    fill = rng.integers(W // 2, W + 1, size=B)
    i = np.full((B, W), -1, np.int32)
    for b in range(B):
        i[b, :fill[b]] = rng.choice(pool, fill[b], replace=False)
    d = np.where(i >= 0, np.arange(W, dtype=np.float32)[None, :], np.inf)
    exp = (rng.random((B, W)) < 0.5) & (i >= 0)
    vis = np.where(rng.random((B, V)) < 0.7,
                   rng.integers(0, pool, (B, V)), -1).astype(np.int32)
    head = rng.integers(0, V, B).astype(np.int32)
    xi = rng.random(B).astype(np.float32)
    cand = rng.integers(0, n_ids, size=(B, K)).astype(np.int32)
    q = K // 4
    cols = rng.permutation(K)
    cand[:, cols[:q]] = i[np.arange(B)[:, None], rng.integers(0, W, (B, q))]
    cand[:, cols[q:2 * q]] = vis[np.arange(B)[:, None], rng.integers(0, V, (B, q))]
    cand = np.where(rng.random((B, K)) < 0.1, -1, cand).astype(np.int32)
    valid = rng.random((B, K)) < 0.9
    valid[0] = False  # a row with no valid candidate
    return (d.astype(np.float32), i, exp, vis, head, xi), cand, valid


ADVERSARIAL = ["collide", "invalid first", "all empty", "all in ring",
               "seen empty"]
ADVERSARIAL_K = [1, 31, 33, 97]


def _adversarial(case, K, B=6, W=13, V=22, seed=0):
    """A beam state and a candidate tile built against the kernel's hash
    table (W and V not multiples of 4, so that the card's 16-byte loads
    meet a ragged head and tail):

    * ``collide``: every id a multiple of 1024, so that they share the low
      bits of a power-of-two table; repeats inside the tile and copies of
      beam and ring ids among them;
    * ``invalid first``: ids repeat, and each id's first occurrence in half
      the rows is invalid while its later copies are valid (all dropped);
    * ``all empty``: rows of all -1 candidates, rows of no valid candidate,
      and rows whose beam and ring are all -1;
    * ``all in ring``: every candidate of a row is one of its ring's ids;
    * ``seen empty``: beam and ring mostly -1, candidates ~30% -1."""
    rng = np.random.default_rng([K, ADVERSARIAL.index(case), seed])
    n_ids = 2 * K + 2
    i = rng.integers(0, 4 * n_ids, (B, W))
    vis = rng.integers(0, 4 * n_ids, (B, V))
    cand = rng.integers(0, n_ids, (B, K))
    take = rng.random((B, K))
    cand = np.where(take < 0.2, i[np.arange(B)[:, None], rng.integers(0, W, (B, K))],
                    cand)
    cand = np.where((take >= 0.2) & (take < 0.4),
                    vis[np.arange(B)[:, None], rng.integers(0, V, (B, K))], cand)
    valid = rng.random((B, K)) < 0.8
    if case == "collide":
        i, vis, cand = i * 1024, vis * 1024, cand * 1024
        cand = np.where(rng.random((B, K)) < 0.1, -1, cand)
    elif case == "invalid first":
        valid[:] = True
        for b in range(0, B, 2):
            _, first = np.unique(cand[b], return_index=True)
            valid[b, first] = False
    elif case == "all empty":
        cand[::2] = -1
        i[1::2] = -1
        vis[1::2] = -1
        valid[1::4] = False  # ids, none of them valid
    elif case == "all in ring":
        cand = vis[np.arange(B)[:, None], rng.integers(0, V, (B, K))]
    else:  # seen empty
        i = np.where(rng.random((B, W)) < 0.9, -1, i)
        vis = np.where(rng.random((B, V)) < 0.9, -1, vis)
        cand = np.where(rng.random((B, K)) < 0.3, -1, cand)
    d = np.where(i >= 0, np.arange(W, dtype=np.float32)[None, :], np.inf)
    fields = (d.astype(np.float32), i.astype(np.int32), np.zeros((B, W), bool),
              vis.astype(np.int32), np.zeros(B, np.int32),
              np.zeros(B, np.float32))
    return fields, cand.astype(np.int32), valid


def _caps(ok):
    """Caps below, at and above the most survivors of a row (at least 1)."""
    most = int(np.asarray(ok).sum(axis=1).max())
    return sorted({max(1, most - 1), max(1, most), most + 3})


def _jax(fields, cand, valid):
    import jax.numpy as jnp
    from ggnn_tpu.ops import beam as jbeam

    st = jbeam.BeamState(*(jnp.asarray(x) for x in fields))
    return jbeam, st, jnp.asarray(cand), None if valid is None else jnp.asarray(valid)


def _torch(fields, cand, valid, device="cpu"):
    st = BeamState(*(torch.from_numpy(x).to(device) for x in fields))
    return (st, torch.from_numpy(cand).to(device),
            None if valid is None else torch.from_numpy(valid).to(device))


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("caller", list(SHAPES))
def test_plain_dedup_matches_jax(caller, with_valid):
    K, W, V = SHAPES[caller]
    fields, cand, valid = _inputs(K + W + V, 16, K, W, V)
    valid = valid if with_valid else None
    jbeam, jst, jcand, jvalid = _jax(fields, cand, valid)
    want = np.asarray(jbeam.beam_dedup_mask(jst, jcand, jvalid))
    got = beam_dedup_mask_plain(*_torch(fields, cand, valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size  # the inputs drop some and keep some


@pytest.mark.parametrize("cap_of", ["below", "at", "above"])
@pytest.mark.parametrize("caller", ["row query step", "sym walk step"])
def test_dedup_compact_matches_jax(caller, cap_of):
    K, W, V = SHAPES[caller]
    cap = {"below": K // 2, "at": K, "above": K + 40}[cap_of]
    fields, cand, valid = _inputs(cap, 24, K, W, V)
    jbeam, jst, jcand, jvalid = _jax(fields, cand, valid)
    want_ok = jbeam.beam_dedup_mask(jst, jcand, jvalid)
    want = np.asarray(jbeam.beam_compact_candidates(jcand, want_ok, cap))
    ok, packed = beam_dedup_compact(*_torch(fields, cand, valid), cap)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(packed.numpy(), want)
    assert packed.shape == (24, min(cap, K))


@pytest.mark.parametrize("K", ADVERSARIAL_K)
@pytest.mark.parametrize("case", ADVERSARIAL)
def test_plain_dedup_adversarial_matches_jax(case, K):
    """The plain dedup and dedup + compaction equal the JAX package's on
    the hash table's adversarial cases, with caps below, at and above the
    survivors."""
    fields, cand, valid = _adversarial(case, K)
    jbeam, jst, jcand, jvalid = _jax(fields, cand, valid)
    want_ok = jbeam.beam_dedup_mask(jst, jcand, jvalid)
    st, c, v = _torch(fields, cand, valid)
    np.testing.assert_array_equal(beam_dedup_mask_plain(st, c, v).numpy(),
                                  np.asarray(want_ok))
    for cap in _caps(want_ok):
        want = np.asarray(jbeam.beam_compact_candidates(jcand, want_ok, cap))
        ok, packed = beam_dedup_compact(st, c, v, cap)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
        np.testing.assert_array_equal(packed.numpy(), want)
    if case in ("invalid first", "all in ring"):
        # the first occurrences are invalid or every id is seen
        assert not np.asarray(want_ok)[0].any()
    if case == "all empty":
        assert not np.asarray(want_ok)[::2].any()
        assert not np.asarray(want_ok)[1::4].any()


def test_cpu_route_launches_nothing(monkeypatch):
    fields, cand, valid = _inputs(3, 8, 96, 64, 64)
    monkeypatch.setattr(beam, "launches", 0)
    monkeypatch.setattr(beam, "launches_compact", 0)
    st, c, v = _torch(fields, cand, valid)
    ok = beam_dedup_mask(st, c, v)
    ok2, packed = beam_dedup_compact(st, c, v, 48)
    assert (beam.launches, beam.launches_compact) == (0, 0)
    np.testing.assert_array_equal(ok.numpy(), beam_dedup_mask_plain(st, c, v).numpy())
    np.testing.assert_array_equal(ok2.numpy(), ok.numpy())
    np.testing.assert_array_equal(
        packed.numpy(), beam_compact_candidates_plain(c, ok, 48).numpy())


def _bad_inputs(kind):
    fields, cand, valid = _inputs(4, 4, 32, 16, 16)
    st, c, v = _torch(fields, cand, valid)
    if kind == "int64 ids":
        c = c.long()
    elif kind == "int8 valid":
        v = v.to(torch.int8)
    elif kind == "strided row":
        c = torch.from_numpy(np.repeat(cand, 2, axis=1))[:, ::2]
    elif kind == "shared memory":  # a row's hash table of 2^15 slots
        c = torch.full((4, 8193), -1, dtype=torch.int32)
        v = None
    return st, c, v


@pytest.mark.parametrize("kind", ["int64 ids", "int8 valid", "strided row",
                                  "shared memory"])
def test_kernel_route_refuses_what_it_cannot_take(kind):
    """The checks that run before a launch raise (reached here through the
    kernel route's own entry, which checks before it touches a device)."""
    with pytest.raises(ValueError, match="beam dedup kernel"):
        beam._launch(*_bad_inputs(kind), 16)


@pytest.mark.parametrize("K, W, V", [*SHAPES.values(), (384, 6048, 2144),
                                     (1000, 64, 64), (1, 8, 1)])
def test_kernel_layout_fits(K, W, V):
    """The kernel's per-block layout (mirrored from ``csrc/beam_dedup.cu``)
    at every walk's shape, k_query 6000's widest beam and ragged K: a
    power-of-two table of >= 2K slots (>= 4K for a seen list above 8K)
    that never grows with W + V beyond that, whole warps of rows, within
    the block's shared memory."""
    slots = beam.table_slots(K, W, V)
    assert slots & (slots - 1) == 0 and slots >= max(32, 2 * K)
    assert slots < (8 if W + V > 8 * K else 4) * max(16, K)
    rows = beam.rows_per_block(K, W, V)
    assert rows in (1, 2, 4, 8)
    assert beam.shared_bytes(K, W, V) == rows * 8 * slots <= beam.MAX_SHARED_BYTES
    assert rows == 1 or rows * 8 * slots <= beam.SMEM_TARGET
    assert K <= 32 * beam.register_chunks(K) or beam.register_chunks(K) == 12


def test_other_device_raises():
    fields, cand, valid = _inputs(5, 4, 32, 16, 16)
    st, c, v = _torch(fields, cand, valid, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        beam_dedup_mask(st, c, v)
    with pytest.raises(ValueError, match="unsupported device"):
        beam_dedup_compact(st, c, v, 8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_case(device, caller, B, seed, with_valid, padded):
    K, W, V = SHAPES.get(caller, caller)
    fields, cand, valid = _inputs(seed, B, K, W, V)
    st, c, v = _torch(fields, cand, valid if with_valid else None, device)
    if padded:  # rows at a stride: a column slice, the ring as beam_pop cuts it
        c = torch.cat([c, c[:, :7]], dim=1)[:, :K]
        st = st._replace(vis=torch.cat([st.vis, st.vis[:, :1]], dim=1)[:, :V])
    return st, c, v


@pytest.mark.cuda
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("caller", [*SHAPES, (384, 6048, 2144), (1000, 64, 64),
                                    (1, 8, 1), (33, 1, 1)])
def test_cuda_kernel_matches_plain(cuda_device, caller, with_valid, padded):
    """Every walk's shape, k_query 6000's widest beam, K above a block's
    256 threads, ragged K: 0 differing entries in ``ok`` and ``packed``."""
    st, c, v = _card_case(cuda_device, caller, 300, 11, with_valid, padded)
    K = c.shape[1]
    n0, c0 = beam.launches, beam.launches_compact
    ok = beam_dedup_mask(st, c, v)
    for cap in (K // 2 + 1, K, K + 5):
        ok2, packed = beam_dedup_compact(st, c, v, cap)
        torch.cuda.synchronize()
        want = beam_dedup_mask_plain(st, c, v)
        assert torch.equal(ok, want) and torch.equal(ok2, want)
        assert torch.equal(packed, beam_compact_candidates_plain(c, want, cap))
    assert (beam.launches - n0, beam.launches_compact - c0) == (4, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("K", ADVERSARIAL_K)
@pytest.mark.parametrize("case", ADVERSARIAL)
def test_cuda_kernel_adversarial_matches_plain(cuda_device, case, K, padded):
    """The hash table's adversarial cases, also at row strides: 0
    differing entries in ``ok`` and, at caps below, at and above the
    survivors, in ``packed``."""
    fields, cand, valid = _adversarial(case, K, B=300)
    st, c, v = _torch(fields, cand, valid, cuda_device)
    if padded:
        c = torch.cat([c, c[:, :3]], dim=1)[:, :K]
        v = torch.cat([v, v[:, :3]], dim=1)[:, :K]
        st = st._replace(i=torch.cat([st.i, st.i[:, :1]], dim=1)[:, :st.i.shape[1]],
                         vis=torch.cat([st.vis, st.vis[:, :1]], dim=1)[:, :st.vis.shape[1]])
    want = beam_dedup_mask_plain(st, c, v)
    assert torch.equal(beam_dedup_mask(st, c, v), want)
    for cap in _caps(want.cpu()):
        ok, packed = beam_dedup_compact(st, c, v, cap)
        torch.cuda.synchronize()
        assert torch.equal(ok, want)
        assert torch.equal(packed, beam_compact_candidates_plain(c, want, cap))


@pytest.mark.cuda
def test_cuda_kernel_replays_from_a_graph(cuda_device):
    """Captured into a CUDA graph and replayed on new contents of its
    inputs, the fused dedup + compaction equals the plain version."""
    st, c, v = _card_case(cuda_device, "row query step", 512, 21, True, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        beam_dedup_compact(st, c, v, 288)  # warm-up: builds and loads the library
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ok, packed = beam_dedup_compact(st, c, v, 288)
    for seed in (22, 23):
        st2, c2, v2 = _card_case(cuda_device, "row query step", 512, seed, True, True)
        for dst, src in ((st.i, st2.i), (st.vis, st2.vis), (c, c2), (v, v2)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = beam_dedup_mask_plain(st, c, v)
        assert torch.equal(ok, want)
        assert torch.equal(packed, beam_compact_candidates_plain(c, want, 288))
