"""The beam's sorted merge and the fused step's cap cut: the sort kernel
(``csrc/beam_sort.cu``) against the ``torch.sort`` route.

On the CPU: CPU tensors take the plain code and count no launch; the
route and the kernel's layout follow the shape at their boundaries; the
wrapper refuses what the kernel cannot take before it touches a device;
launches count once per replay of a captured graph (a fake launch). On the
card the kernel must be bit-identical to the ``torch.sort`` route
(``beam_insert_plain``, ``cap_candidates_plain`` on the same CUDA tensors)
in every output -- distances' bits, ids, flags, the order of ties -- at
every walk's shape, with ``beam_pop``'s +inf holes, empty slots, -1
candidates, a row mask, tight and open criteria, equal distances, -0.0 and
+0.0, rows with nothing finite, strided, repeated and unaligned rows, and
replayed from a CUDA graph. This file imports no JAX, so the card cases
run where JAX is not installed::

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_beam_sort.py
"""

import numpy as np
import pytest
import torch

from ggnn_torch.ops import beam_sort
from ggnn_torch.ops.beam import (
    BeamState,
    beam_insert,
    beam_insert_plain,
    cap_candidates,
    cap_candidates_plain,
)
from ggnn_torch.utils import graphs
from torch_reference import one_torch_thread  # noqa: F401

# (W beam columns, K candidates, kept columns: None for an insert, else
# the cut's cap) of every walk at the benchmark's k_build 24, P 8, and of
# the smoke's k_build 48; the last takes the torch.sort route
SHAPES = {
    "fused query step": (32, 32, None),
    "fused query cap cut": (0, 192, 32),
    "fused query seed insert": (32, 8, None),
    "row query step": (64, 144, None),
    "row query uncapped step": (64, 192, None),
    "row query seed insert": (64, 32, None),
    "fused merge cap cut": (0, 192, 64),
    "fused merge step": (64, 64, None),
    "f32 merge and sym walk step": (64, 96, None),
    "merge own insert": (64, 1, None),
    "k_build 48 row step": (64, 288, None),
    "k_build 48 uncapped merge step": (96, 384, None),  # B in runs of 256
    "k_build 48 cap cut": (0, 384, 96),
    "torch.sort route": (600, 500, None),
}
# distances drawn from few values: ties, and -0.0 beside +0.0
TIES = np.array([0.0, -0.0, 0.5, 1.0, 1.0, 2.0], np.float32)


def _case(seed, B, W, K, ties):
    """A beam as the walks leave it and a tile of candidates, numpy: each
    row's finite entries ascending (a stable sort) in a random prefix, with
    +inf holes blanked at random (``beam_pop``'s, flagged or not) and empty
    slots; candidates with ~20% -1 ids and some +inf distances; criteria
    from +inf (everything admitted) to 0 (nothing), one row's beam and
    candidates all +inf; a ~80% row mask."""
    rng = np.random.default_rng(seed)

    def dists(shape):
        if ties:
            return rng.choice(TIES, shape).astype(np.float32)
        return (rng.random(shape) * 4).astype(np.float32)

    d = np.full((B, W), np.inf, np.float32)
    i = np.full((B, W), -1, np.int32)
    exp = np.zeros((B, W), bool)
    for b in range(B):
        n = int(rng.integers(0, W + 1))
        d[b, :n] = np.sort(dists(n), kind="stable")
        i[b, :n] = rng.choice(1 << 24, n, replace=False)
        exp[b, :n] = rng.random(n) < 0.5
        holes = rng.random(W) < 0.2
        d[b, holes], i[b, holes] = np.inf, -1
        exp[b, holes] = rng.random(int(holes.sum())) < 0.7
    cd = dists((B, K))
    cd[rng.random((B, K)) < 0.05] = np.inf
    ci = rng.integers(1 << 24, 1 << 25, (B, K)).astype(np.int32)
    ci[rng.random((B, K)) < 0.2] = -1
    crit = rng.choice(np.array([np.inf, 0.5, 1.0, 2.0, 3.0, 0.0], np.float32), B)
    d[0], i[0], cd[0] = np.inf, -1, np.inf  # nothing finite
    mask = rng.random(B) < 0.8
    return d, i, exp, cd, ci, crit, mask


def _state(d, i, exp, device="cpu"):
    B = d.shape[0]
    t = [torch.from_numpy(a).to(device) for a in (d, i, exp)]
    return BeamState(*t, torch.full((B, 4), -1, dtype=torch.int32, device=device),
                     torch.zeros(B, dtype=torch.int32, device=device),
                     torch.zeros(B, device=device))


def _same(got, want):
    """Bit-identical tensors: distances by their bits."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), int((got != want).sum())


def test_cpu_route_takes_the_plain_code(monkeypatch):
    monkeypatch.setattr(beam_sort, "launches", 0)
    monkeypatch.setattr(beam_sort, "launches_torch", 0)
    for label, (W, K, cap) in SHAPES.items():
        d, i, exp, cd, ci, crit, mask = _case(1, 9, W or 8, K, True)
        st = _state(d, i, exp)
        c, cdt, cr = map(torch.from_numpy, (ci, cd, crit))
        if cap is None:
            for m in (None, torch.from_numpy(mask)):
                got = beam_insert(st, c, cdt, m, criteria=cr)
                want = beam_insert_plain(st, c, cdt, m, criteria=cr)
                for g, w in zip(got[:3], want[:3]):
                    _same(g, w)
        else:
            for g, w in zip(cap_candidates(c, cdt, cap, criteria=cr),
                            cap_candidates_plain(c, cdt, cap, criteria=cr)):
                _same(g, w)
    assert (beam_sort.launches, beam_sort.launches_torch) == (0, 0)


def test_plain_insert_is_a_stable_sort():
    """The plain route's order, which the kernel must give: finite entries
    by distance (-0.0 equal to +0.0), ties in column order, beam columns
    before candidate columns, the +inf entries after them in column order,
    rejected candidates as (+inf, -1, False)."""
    st = _state(np.array([[0.0, np.inf, 1.0, np.inf]], np.float32),
                np.array([[5, -1, 6, -1]], np.int32),
                np.array([[True, True, False, False]]))
    ids, ds = cap_candidates_plain(
        torch.tensor([[7, 8, -1, 9, 10]], dtype=torch.int32),
        torch.tensor([[1.0, -0.0, 0.1, 3.0, 0.5]]), 4, criteria=torch.tensor([2.0]))
    assert ids.tolist() == [[8, 10, 7, -1]] and ds[0, 3] == np.inf
    out = beam_insert_plain(
        st, torch.tensor([[7, 8, -1, 9]], dtype=torch.int32),
        torch.tensor([[1.0, -0.0, 0.1, 3.0]]), criteria=torch.tensor([2.0]))
    assert out.i.tolist() == [[5, 8, 6, 7]]
    assert out.exp.tolist() == [[True, False, False, False]]
    assert str(out.d[0, 1].item()) == "-0.0"


@pytest.mark.parametrize("W, K, keys, rows", [
    (32, 32, 2, 8), (0, 64, 2, 8), (64, 1, 8, 8), (0, 256, 8, 8),
    (64, 192, 8, 8), (96, 384, 8, 8), (0, 768, 8, 8), (1000, 24, 8, 4),
    (0, 1024, 8, 4)])
def test_route_and_layout_at_the_boundaries(W, K, keys, rows):
    """Up to 64 keys a row two keys a lane, to 1,024 eight (B past 256
    admitted candidates in runs), beyond that the torch.sort route; a
    block's rows halve once their keys pass 48 KB."""
    assert beam_sort.route(W, K) == beam_sort.KERNEL
    assert beam_sort.keys_per_lane(W, K) == keys
    assert beam_sort.rows_per_block(W, K) == rows
    assert rows * 8 * (W + K) <= beam_sort.SMEM_TARGET  # a row's keys, 8 B each


@pytest.mark.parametrize("W, K", [(0, 1025), (1000, 25), (600, 500)])
def test_wider_rows_take_the_torch_route(W, K):
    assert beam_sort.route(W, K) == beam_sort.TORCH
    with pytest.raises(ValueError, match="above 1024"):
        beam_sort.keys_per_lane(W, K)


def _bad(kind):
    d, i, exp, cd, ci, crit, mask = _case(2, 4, 16, 16, False)
    st = _state(d, i, exp)
    c, cdt, cr, m = map(torch.from_numpy, (ci, cd, crit, mask))
    width = 16
    if kind == "int64 ids":
        c = c.long()
    elif kind == "f64 distances":
        cdt = cdt.double()
    elif kind == "strided row":
        cdt = torch.from_numpy(np.repeat(cd, 2, axis=1))[:, ::2]
    elif kind == "int8 mask":
        m = m.to(torch.int8)
    elif kind == "mask and cut":
        width = 8
    elif kind == "criteria [B, 1]":
        cr = cr[:, None]
    elif kind == "wider than the keys":
        width, m = 33, None
    elif kind == "too many keys":
        c = torch.full((4, 1009), -1, dtype=torch.int32)
        cdt = torch.zeros((4, 1009))
        m = None
    return c, cdt, cr, width, (st.d, st.i, st.exp), m


@pytest.mark.parametrize("kind", ["int64 ids", "f64 distances", "strided row",
                                  "int8 mask", "mask and cut", "criteria [B, 1]",
                                  "wider than the keys", "too many keys"])
def test_kernel_route_refuses_what_it_cannot_take(kind, monkeypatch):
    """The checks before a launch raise (reached with CPU tensors through
    the kernel route's own entry, which checks before it touches a
    device)."""
    monkeypatch.setattr(beam_sort, "_call", None)  # never reached
    c, cdt, cr, width, bm, m = _bad(kind)
    with pytest.raises(ValueError, match="beam sort kernel"):
        beam_sort.merge(c, cdt, cr, width, beam=bm, row_mask=m)


def test_launches_counted_per_replay(monkeypatch):
    """A launch counts now, or -- captured into a graph -- once per replay;
    the torch.sort route counts on its own counter."""
    calls = []
    monkeypatch.setattr(beam_sort, "_call", lambda dev, args: calls.append(args) or 0)
    monkeypatch.setattr(beam_sort, "launches", 0)
    monkeypatch.setattr(beam_sort, "launches_torch", 0)
    d, i, exp, cd, ci, crit, mask = _case(3, 5, 32, 32, False)
    st = _state(d, i, exp)
    c, cdt, cr, m = map(torch.from_numpy, (ci, cd, crit, mask))
    beam_sort.merge(c, cdt, cr, 32, beam=(st.d, st.i, st.exp), row_mask=m)
    beam_sort.count_torch()
    assert (beam_sort.launches, beam_sort.launches_torch, len(calls)) == (1, 1, 1)
    graphs._tls.recording = rec = []
    try:
        beam_sort.merge(c, cdt, cr, 16)
        beam_sort.count_torch()
    finally:
        graphs._tls.recording = None
    assert (beam_sort.launches, beam_sort.launches_torch, len(calls)) == (1, 1, 2)
    for _ in range(3):  # three replays of the captured step
        for fn, args in rec:
            fn(*args)
    assert (beam_sort.launches, beam_sort.launches_torch) == (4, 4)
    # the cut's launch: no beam, no flags, the rows' 16-byte alignment
    args = calls[1]
    assert args[:6] == [None, 0] * 3 and args[14] is None
    assert args[15:19] == [5, 0, 32, 16]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card(device, seed, W, K, ties, B=300):
    d, i, exp, cd, ci, crit, mask = _case(seed, B, W, K, ties)
    st = _state(d, i, exp, device)
    c, cdt, cr, m = (torch.from_numpy(a).to(device) for a in (ci, cd, crit, mask))
    return st, c, cdt, cr, m


def _check(st, c, cdt, cr, m, cap):
    """The public entry (kernel or torch.sort route by shape) against the
    torch.sort route on the same tensors; returns the launches it made."""
    n0, t0 = beam_sort.launches, beam_sort.launches_torch
    if cap is None:
        got = beam_insert(st, c, cdt, m, criteria=cr)
        want = beam_insert_plain(st, c, cdt, m, criteria=cr)
        pairs = zip(got[:3], want[:3])
    else:
        pairs = zip(cap_candidates(c, cdt, cap, criteria=cr),
                    cap_candidates_plain(c, cdt, cap, criteria=cr))
    torch.cuda.synchronize()
    for g, w in pairs:
        _same(g, w)
    return beam_sort.launches - n0, beam_sort.launches_torch - t0


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("label, masked", [
    (label, masked) for label, (_, _, cap) in SHAPES.items()
    for masked in ((False,) if cap is not None else (False, True))])
def test_cuda_kernel_matches_torch_route(cuda_device, label, masked, ties):
    W, K, cap = SHAPES[label]
    st, c, cdt, cr, m = _card(cuda_device, 11, W, K, ties)
    n, t = _check(st, c, cdt, cr, m if masked else None, cap)
    kernel = beam_sort.route(W, K) == beam_sort.KERNEL
    assert (n, t) == ((1, 0) if kernel else (0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["row stride", "repeated row", "unaligned"])
@pytest.mark.parametrize("label", ["fused query step", "row query step",
                                   "fused query cap cut", "k_build 48 cap cut"])
def test_cuda_kernel_strided_rows(cuda_device, label, layout):
    """Candidates at a row stride (a slice of a wider tile, as the sym
    walk's pair distances), one row repeated (stride 0, as the row query's
    seeds) and rows off the 16-byte boundary (the scalar loads)."""
    W, K, cap = SHAPES[label]
    st, c, cdt, cr, m = _card(cuda_device, 12, W, K, True)
    if layout == "row stride":
        c = torch.cat([c, c[:, :8]], 1)[:, :K]
        cdt = torch.cat([cdt, cdt], 1)[:, :K]
    elif layout == "repeated row":
        c, cdt = c[:1].expand_as(c), cdt[:1].expand_as(cdt)
    else:
        c = torch.cat([c[:, :1], c], 1)[:, 1:]
        cdt = torch.cat([cdt[:, :1], cdt], 1)[:, 1:]
    assert _check(st, c, cdt, cr, None if cap is not None else m, cap) == (1, 0)


@pytest.mark.cuda
def test_cuda_kernel_signed_zeros(cuda_device):
    """Rows of -0.0 and +0.0 only, in the beam (as torch.sort on the card
    leaves them) and among the candidates: the kernel orders them as
    torch.sort does on the card."""
    B, W, K = 256, 32, 32
    rng = np.random.default_rng(13)
    d = np.where(rng.random((B, W)) < 0.5, -0.0, 0.0).astype(np.float32)
    d = torch.sort(torch.from_numpy(d).to(cuda_device), stable=True)[0].cpu().numpy()
    cd = np.where(rng.random((B, K)) < 0.5, -0.0, 0.0).astype(np.float32)
    st = _state(d, np.arange(B * W, dtype=np.int32).reshape(B, W),
                rng.random((B, W)) < 0.5, cuda_device)
    c = torch.arange(B * K, dtype=torch.int32, device=cuda_device).reshape(B, K) + B * W
    cdt = torch.from_numpy(cd).to(cuda_device)
    cr = torch.ones(B, device=cuda_device)
    assert _check(st, c, cdt, cr, None, None) == (1, 0)
    assert _check(st, c, cdt, cr, None, 16) == (1, 0)


@pytest.mark.cuda
def test_cuda_kernel_replays_from_a_graph(cuda_device):
    """Captured into a CUDA graph and replayed on new contents of its
    inputs, the merge equals the torch.sort route."""
    st, c, cdt, cr, m = _card(cuda_device, 21, 64, 144, False, B=512)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        beam_insert(st, c, cdt, m, criteria=cr)  # warm-up: builds and loads the library
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = beam_insert(st, c, cdt, m, criteria=cr)
    for seed in (22, 23):
        st2, c2, cdt2, cr2, m2 = _card(cuda_device, seed, 64, 144, seed == 23, B=512)
        for dst, src in zip((*st[:3], c, cdt, cr, m), (*st2[:3], c2, cdt2, cr2, m2)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = beam_insert_plain(st, c, cdt, m, criteria=cr)
        for g, w in zip(out[:3], want[:3]):
            _same(g, w)
