"""The walks' pop (``beam_pop``) against the JAX package's, and its kernel
against the plain route.

``beam_pop_plain`` (the CPU route and the oracle of ``csrc/beam_pop.cu``)
is held exactly against ``ggnn_tpu.ops.beam.beam_pop`` on the same numpy
inputs at each walk's shape (the fused query's at both benchmark operating
points, the fused merge's, the row query's, the sym walk's with its own
``criteria``, k_query 6000's widest beam, a one-column beam and a ragged
one), with and without a row mask: hits on both sides of ``k_best``, rows
with nothing eligible (all expanded, a NaN criterion), rows where every
entry is eligible (an infinite criterion), NaN and infinite distances in
the beam; and over a chain of pops whose ring wraps several times. The
kernel is compared with the plain version on the card only (every output
bit for bit, the ring written in place), also replayed from a CUDA graph,
and the fused and row walks answer alike with either pop at D = 128 and
960; the JAX package is imported inside the CPU tests, so that the
card-only tests run where JAX is not installed::

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_beam_pop.py
"""

import numpy as np
import pytest
import torch

from ggnn_torch.ops import beam
from ggnn_torch.ops.beam import BeamState, beam_pop, beam_pop_plain
from torch_reference import one_torch_thread  # noqa: F401

# (W beam, P pops a step, k_best, V ring, criteria given) of each walk, as
# ggnn_torch/config.py and the benchmark's operating points size them
SHAPES = {
    "fused query (gist1m)": (32, 16, 10, 3200, False),
    "fused query (sift1m)": (32, 8, 10, 128, False),
    "fused merge": (64, 8, 25, 192, False),
    "row query": (64, 8, 10, 192, False),
    "sym walk": (64, 8, 12, 64, True),
    "k_query 6000": (6048, 32, 6000, 32, False),
    "one column": (1, 1, 1, 1, False),
    "ragged": (45, 5, 40, 7, True),
}


def _fields(seed, B, W, V, k_best=1, P=1):
    """A beam as the walks leave it: each row's finite distances ascending
    in a prefix of a quarter to all of W, ids distinct, ~40% of the filled
    entries expanded, a few holes (+inf, -1) and NaN distances; the ring
    partly filled at a random head. Row 0 is all expanded, row 1's slack
    NaN, row 2's +inf (every unexpanded entry eligible), row 3 empty; in
    rows 4 to B / 2 every column is filled and expanded up to P / 2 short
    of ``k_best``, so that their P hits lie on both sides of it."""
    rng = np.random.default_rng(seed)
    fill = rng.integers(max(1, W // 4), W + 1, size=B)
    fill[4:B // 2] = W
    col = np.arange(W)[None, :]
    d = np.sort(rng.random((B, W)).astype(np.float32), axis=1)
    i = np.stack([rng.permutation(4 * W + 8)[:W] for _ in range(B)])
    hole = (col >= fill[:, None]) | (rng.random((B, W)) < 0.1)
    d = np.where(hole, np.inf, d).astype(np.float32)
    d[rng.random((B, W)) < 0.03] = np.nan
    i = np.where(hole, -1, i).astype(np.int32)
    exp = (rng.random((B, W)) < 0.4) & (i >= 0)
    exp[0] = i[0] >= 0
    i[3], d[3], exp[3] = -1, np.inf, False
    done = max(0, k_best - P // 2)
    exp[4:B // 2, :done] = i[4:B // 2, :done] >= 0
    vis = np.where(rng.random((B, V)) < 0.5, rng.integers(0, 4 * W + 8, (B, V)),
                   -1).astype(np.int32)
    head = rng.integers(0, V, B).astype(np.int32)
    xi = (rng.random(B) * 0.5).astype(np.float32)
    xi[1], xi[2], xi[4:B // 2] = np.nan, np.inf, 1.0
    return d, i, exp, vis, head, xi


def _criteria(fields):
    """The sym walk's criterion: the best distance + xi."""
    return (fields[0][:, 0] + fields[5]).astype(np.float32)


def _torch_state(fields, device="cpu"):
    return BeamState(*(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                       for x in fields))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_pops_equal(got, want):
    """(anchors, active, state) equal in every field, distances bit for
    bit."""
    ga, gact, gst = got
    wa, wact, wst = want
    np.testing.assert_array_equal(_bits(ga), _bits(wa), err_msg="anchors")
    np.testing.assert_array_equal(_bits(gact), _bits(wact), err_msg="active")
    for name, g, w in zip(BeamState._fields, gst, wst):
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


def _numpy(out):
    a, act, st = out
    return (a.cpu().numpy(), act.cpu().numpy(),
            BeamState(*(t.cpu().numpy() for t in st)))


def _jax_pop(fields, P, k_best, mask, crit):
    import jax.numpy as jnp
    from ggnn_tpu.ops import beam as jbeam

    st = jbeam.BeamState(*(jnp.asarray(x) for x in fields))
    a, act, st = jbeam.beam_pop(
        st, P, k_best, None if mask is None else jnp.asarray(mask),
        criteria=None if crit is None else jnp.asarray(crit))
    return (np.asarray(a), np.asarray(act),
            BeamState(*(np.asarray(x) for x in st)))


def _case(shape, masked, seed, B=12):
    W, P, k_best, V, with_crit = SHAPES[shape]
    fields = _fields(seed, B, W, V, k_best, P)
    mask = np.random.default_rng(seed + 1).random(B) < 0.75 if masked else None
    crit = _criteria(fields) if with_crit else None
    return fields, P, k_best, mask, crit


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_pop_matches_jax(shape, masked):
    fields, P, k_best, mask, crit = _case(shape, masked, 7)
    want = _jax_pop(fields, P, k_best, mask, crit)
    got = beam_pop_plain(_torch_state(fields), P, k_best,
                         None if mask is None else torch.from_numpy(mask),
                         criteria=None if crit is None else torch.from_numpy(crit))
    _assert_pops_equal(_numpy(got), want)
    anchors, active = want[0], want[1]
    assert not active[0] and not active[3]  # all expanded; empty
    if crit is None:
        assert not active[1]  # a NaN criterion admits nothing
    if mask is not None:
        assert not active[~mask].any()
    W = fields[0].shape[1]
    if W > k_best and P > 1:
        # hits on both sides of k_best: kept inside the prefix, blanked past it
        popped = want[2].exp & ~fields[2]
        col = np.arange(W)[None, :]
        assert (popped & (col < k_best)).any()
        assert (popped & (col >= k_best)).any() and (
            want[2].i[popped & (col >= k_best)] == -1).all()
    assert (anchors != -1).any()


def _chain(fields, pops, P, k_best, pop, to_numpy):
    """``pops`` pops in a row; the state (and the pop's outputs) after
    each."""
    out, st = [], fields
    for _ in range(pops):
        res = pop(st, P, k_best)
        out.append(to_numpy(res))
        st = res[2]
    return out


def test_plain_ring_wraps_over_pops_like_jax():
    """Eight pops of 6 on a ring of 20 slots: the ring wraps more than
    twice, every state equal to the JAX package's."""
    fields = list(_fields(3, 10, 200, 20))
    fields[5][:] = np.inf  # every unexpanded entry eligible, on every pop
    import jax.numpy as jnp
    from ggnn_tpu.ops import beam as jbeam

    want = _chain(jbeam.BeamState(*(jnp.asarray(x) for x in fields)), 8, 6, 10,
                  jbeam.beam_pop,
                  lambda r: (np.asarray(r[0]), np.asarray(r[1]),
                             BeamState(*(np.asarray(x) for x in r[2]))))
    got = _chain(_torch_state(fields), 8, 6, 10, beam_pop_plain, _numpy)
    for g, w in zip(got, want):
        _assert_pops_equal(g, w)
    assert (want[-1][2].vis_head != fields[4]).any()


def test_cpu_route_is_the_plain_pop(monkeypatch):
    """On CPU tensors ``beam_pop`` is the plain version, out of place, and
    counts no pop of the card."""
    monkeypatch.setattr(beam, "pops_kernel", 0)
    monkeypatch.setattr(beam, "pops_plain", 0)
    fields, P, k_best, mask, crit = _case("sym walk", True, 9)
    st = _torch_state(fields)
    m, c = torch.from_numpy(mask), torch.from_numpy(crit)
    got = beam_pop(st, P, k_best, m, criteria=c)
    _assert_pops_equal(_numpy(got), _numpy(beam_pop_plain(st, P, k_best, m,
                                                          criteria=c)))
    _assert_pops_equal(_numpy((got[0], got[1], st)),
                       (got[0].numpy(), got[1].numpy(), BeamState(*fields)))
    assert beam.pop_launches() == {"kernel": 0, "plain": 0}


def _bad(kind):
    fields, P, k_best, mask, crit = _case("row query", True, 4, B=4)
    st = _torch_state(fields)
    m = torch.from_numpy(mask)
    if kind == "f64 distances":
        st = st._replace(d=st.d.double())
    elif kind == "int64 ring":
        st = st._replace(vis=st.vis.long())
    elif kind == "strided ids":
        st = st._replace(i=torch.from_numpy(np.repeat(fields[1], 2, axis=1))[:, ::2])
    elif kind == "strided head":
        st = st._replace(vis_head=torch.from_numpy(np.repeat(fields[4], 2))[::2])
    elif kind == "k_best past the beam":
        k_best = fields[0].shape[1] + 1
    elif kind == "short mask":
        m = m[:3]
    return st, P, k_best, m, None


@pytest.mark.parametrize("kind", ["f64 distances", "int64 ring", "strided ids",
                                  "strided head", "k_best past the beam",
                                  "short mask"])
def test_kernel_route_refuses_what_it_cannot_take(kind):
    """The checks that run before a launch raise (reached here through the
    kernel route's own entry, which checks before it touches a device)."""
    with pytest.raises(ValueError, match="beam pop kernel"):
        beam._pop_launch(*_bad(kind))


def test_other_device_raises():
    st = _torch_state(_fields(5, 4, 32, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        beam_pop(st, 4, 10)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_pop(device, fields, P, k_best, mask, crit):
    """The kernel on the card against the plain route on the same state:
    every output equal, the kernel's state the same tensors updated in
    place, one launch and one plain pop counted."""
    st = _torch_state(fields, device)
    m = None if mask is None else torch.from_numpy(mask).to(device)
    c = None if crit is None else torch.from_numpy(crit).to(device)
    before = beam.pop_launches()
    want = _numpy(beam_pop_plain(st, P, k_best, m, criteria=c))
    ptrs = [t.data_ptr() for t in st]
    got = beam_pop(st, P, k_best, m, criteria=c)
    torch.cuda.synchronize()
    _assert_pops_equal(_numpy(got), want)
    assert all(a is b for a, b in zip(got[2], st))
    assert [t.data_ptr() for t in got[2]] == ptrs
    assert got[2].vis.is_contiguous() and got[2].vis.shape == fields[3].shape
    after = beam.pop_launches()
    assert (after["kernel"] - before["kernel"],
            after["plain"] - before["plain"]) == (1, 1)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_kernel_matches_plain(cuda_device, shape, masked):
    """Every walk's shape at 300 rows (many blocks), bit for bit."""
    _card_pop(cuda_device, *_case(shape, masked, 11, B=300))


@pytest.mark.cuda
def test_cuda_ring_wraps_over_pops(cuda_device):
    fields = list(_fields(3, 300, 200, 20))
    fields[5][:] = np.inf
    want = _chain(_torch_state(fields, cuda_device), 8, 6, 10, beam_pop_plain,
                  _numpy)
    got = _chain(_torch_state(fields, cuda_device), 8, 6, 10, beam_pop, _numpy)
    for g, w in zip(got, want):
        _assert_pops_equal(g, w)


@pytest.mark.cuda
def test_cuda_kernel_replays_from_a_graph(cuda_device):
    """Captured into a CUDA graph and replayed on new contents of the
    state, the pop equals the plain version on those contents."""
    fields, P, k_best, mask, crit = _case("sym walk", True, 21, B=512)
    st = _torch_state(fields, cuda_device)
    m = torch.from_numpy(mask).to(cuda_device)
    c = torch.from_numpy(crit).to(cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: builds and loads the library
        beam_pop(BeamState(*(t.clone() for t in st)), P, k_best, m, criteria=c)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        anchors, active, _ = beam_pop(st, P, k_best, m, criteria=c)
    for seed in (22, 23):
        new = _case("sym walk", True, seed, B=512)
        for dst, src in zip(st, _torch_state(new[0], cuda_device)):
            dst.copy_(src)
        m.copy_(torch.from_numpy(new[3]))
        c.copy_(torch.from_numpy(new[4]))
        want = _numpy(beam_pop_plain(st, P, k_best, m, criteria=c))
        graph.replay()
        torch.cuda.synchronize()
        _assert_pops_equal(_numpy((anchors, active, st)), want)


@pytest.mark.cuda
def test_cuda_pops_in_a_walk_program(cuda_device):
    """A walk of pops alone on the graph route (``graphs.run_steps``: the
    kernel writes the program's static carry in place, the copy-back of
    the same tensors) equals a chain of plain pops, and each replayed pop
    counts one launch."""
    from ggnn_torch.utils import graphs

    fields = list(_fields(5, 300, 200, 24))
    fields[5][:] = np.inf

    def step(st, consts):
        _, active, st = beam_pop(st, 4, 10)
        return st, active

    st = _torch_state(fields, cuda_device)
    live = torch.ones((300,), dtype=torch.bool, device=cuda_device)
    before = beam.pop_launches()
    got, *_ = graphs.run_steps(step, st, (), live, it=0, steps=8, live_n=300,
                               floor=0, route=graphs.GRAPHS,
                               name=("test pops",))
    torch.cuda.synchronize()
    after = beam.pop_launches()
    want = _chain(_torch_state(fields, cuda_device), 8, 4, 10, beam_pop_plain,
                  _numpy)[-1][2]
    for name, g, w in zip(BeamState._fields, got, want):
        np.testing.assert_array_equal(_bits(g.cpu().numpy()), _bits(w),
                                      err_msg=name)
    # the capture's warm-up step and the eight replayed steps
    assert after["kernel"] - before["kernel"] == 9
    assert after["plain"] == before["plain"]
    graphs.clear()


@pytest.mark.cuda
def test_cuda_copy_back_of_the_same_tensor_launches_nothing(cuda_device):
    """``_Program._steps`` copies each carry tensor back into its static
    buffer; the ring the pop wrote in place is that buffer itself, and a
    copy of a tensor onto itself launches nothing on the card."""
    ring = torch.zeros((1024, 3200), dtype=torch.int32, device=cuda_device)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ring.copy_(ring)
        torch.cuda.synchronize()
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    assert device_events == []


def _walk_base(d, n=2048, nq=256, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(16, d)).astype(np.float32)

    def sample(m):
        z = rng.normal(size=(m, 16)).astype(np.float32)
        return z @ w + rng.normal(0, 0.3, size=(m, d)).astype(np.float32)

    return sample(n), sample(nq)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [128, 960])
def test_card_walks_equal_with_either_pop(cuda_device, dim, monkeypatch):
    """The fused and the row walk give the same answers, bit for bit, with
    the pop kernel and with the plain pop on the card, and the kernel's
    side counts no plain pop."""
    from ggnn_torch import GGNN
    from ggnn_torch.build import sym as sym_mod
    from ggnn_torch.ops import traverse as traverse_mod
    from ggnn_torch.query import fused as fused_mod
    from ggnn_torch.utils import graphs

    base, query = _walk_base(dim)
    g = GGNN(device=cuda_device)
    g.set_base(base)
    g.build(k_build=16, tau_build=0.5, refinement_iterations=1)
    g.build_fused_index()
    q = torch.from_numpy(query).to(cuda_device)

    def answers():
        fused = g.query(q, 10, 0.6, 200, engine="fused", pops_per_iter=8)
        row = g.query(q, 10, 0.6, 200, engine="row", pops_per_iter=8)
        torch.cuda.synchronize()
        return [np.asarray(t) for t in (*fused, *row)]

    before = beam.pop_launches()
    kernel = answers()
    after = beam.pop_launches()
    assert after["kernel"] > before["kernel"] and after["plain"] == before["plain"]
    graphs.clear()
    for m in (fused_mod, traverse_mod, sym_mod):
        monkeypatch.setattr(m, "beam_pop", beam_pop_plain)
    plain = answers()
    graphs.clear()
    assert beam.pop_launches()["kernel"] == after["kernel"]
    assert beam.pop_launches()["plain"] > after["plain"]
    for a, b in zip(kernel, plain):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    g.close()
