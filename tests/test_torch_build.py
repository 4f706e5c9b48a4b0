"""The port's construction stages against the JAX package's.

A module fixture runs the JAX build prefix stage by stage (top merge ->
select -> sym on layer 0, top merge + select on layer 1) and keeps every
stage's input and output. Each port stage is fed the reference's input for
that stage: the deterministic stages must match exactly (top merge ids,
selection given the same uniforms, sym-buffer merge, the request scatter,
the mutual filter, the quantizer codes); the stages that compare f32
distances against criteria (sym pass, merge walk) are held by the
neighbour-set overlap of their output, which is reported and bounded. The
graph ``.npz`` format must load in both directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu import graph as jgraph
from ggnn_tpu.build import select as jselect
from ggnn_tpu.build import sym as jsym
from ggnn_tpu.build.merge import merge_layer as j_merge_layer
from ggnn_tpu.build.top_merge import top_merge_layer as j_top_merge
from ggnn_tpu.config import DistanceMeasure as JMeasure
from ggnn_tpu.config import GraphConfig as JGraphConfig
from ggnn_tpu.ops.distance import squared_norms as j_squared_norms
from ggnn_tpu.query import fused as jfused
from ggnn_torch import graph as tgraph
from ggnn_torch.build import select as tselect
from ggnn_torch.build import sym as tsym
from ggnn_torch.build.merge import merge_layer
from ggnn_torch.build.top_merge import top_merge_layer
from ggnn_torch.config import DistanceMeasure, GraphConfig
from ggnn_torch.ops.distance import squared_norms
from ggnn_torch.query.fused import encode_u8, make_adjacency, quantizer_for

N, D, K = 2048, 64, 16
TAU = 0.5


def _t(x):
    return torch.from_numpy(np.array(x))


def _manifold(rng, n, d, d_latent=8, scale=30.0):
    w = rng.normal(size=(d_latent, d)).astype(np.float32) / np.sqrt(d_latent)
    z = rng.normal(size=(n, d_latent)).astype(np.float32)
    return (z @ w * scale + 128.0).astype(np.float32)


def _select_statics(cfg, layer):
    return dict(
        num_segments=cfg.Bs[layer], S=cfg.layer_segment_size(layer),
        S_offset=cfg.layer_segment_offset_count(layer), Sglob=cfg.S, G=cfg.G,
        SG=cfg.SG, SG_offset=cfg.SG_off, use_translation=layer > 0,
        N_next=cfg.Ns[layer + 1],
    )


def _overlap(a, b):
    """Mean fraction of shared neighbour ids per row."""
    return float(np.mean([
        len(set(x[x >= 0]) & set(y[y >= 0])) / max(1, len(set(x[x >= 0])))
        for x, y in zip(a, b)
    ]))


def _assert_ids_equal_up_to_near_ties(got, want, base, trans, measure):
    """Ids equal, except where two neighbours' distances are so close that
    the f32 summation order decides their rank: there the exact (float64)
    distances of both ids must agree to 1e-4 relative -- the precision of
    ``|q|^2 + |c|^2 - 2 q.c`` in f32 at this data's offset -- and such swaps
    stay rare."""
    diff = got != want
    assert diff.mean() <= 1e-3, f"{diff.sum()} of {diff.size} ids differ"
    rows, cols = np.nonzero(diff)
    node = rows if trans is None else trans[rows]
    to_base = (lambda i: i) if trans is None else (lambda i: trans[i])
    x = base.astype(np.float64)

    def dist(a, b):
        if measure == DistanceMeasure.Euclidean:
            return np.sum((x[a] - x[b]) ** 2, axis=-1)
        dot = np.sum(x[a] * x[b], axis=-1)
        return 1.0 - dot / np.sqrt(np.sum(x[a] ** 2, -1) * np.sum(x[b] ** 2, -1))

    g, w = got[rows, cols], want[rows, cols]
    assert np.all((g >= 0) & (w >= 0))
    np.testing.assert_allclose(dist(node, to_base(g)), dist(node, to_base(w)),
                               rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def ref():
    """The reference's build prefix, every stage's input and output kept."""
    rng = np.random.default_rng(21)
    base = _manifold(rng, N, D)
    cfg = JGraphConfig.create(N=N, D=D, KBuild=K)
    b = jnp.asarray(base)
    b_sq = j_squared_norms(b)
    E = JMeasure.Euclidean
    r = {"base": base, "cfg": cfg, "u": [], "sel": [None], "trans": [None]}
    nbrs0, nn1_0 = j_top_merge(b, b_sq, None, cfg, 0, E)
    r["top0"] = (np.asarray(nbrs0), np.asarray(nn1_0))
    nn1_stats = jnp.stack([jnp.mean(nn1_0), jnp.max(nn1_0)])
    r["nn1_stats"] = np.asarray(nn1_stats)
    nn1 = [nn1_0]
    trans = [jnp.zeros((0,), jnp.int32)]
    for layer in (0, 1):
        if layer:
            nbrs1, nn1_1 = j_top_merge(b, b_sq, trans[1], cfg, 1, E)
            r["top1"] = (np.asarray(nbrs1), np.asarray(nn1_1))
            nn1.append(nn1_1)
        u = (1.0 - rng.random(cfg.Ns[layer])).astype(np.float32)
        sel, tr = jselect._select(
            jnp.asarray(u), nn1[layer],
            trans[layer] if layer else jnp.zeros((0,), jnp.int32),
            **_select_statics(cfg, layer),
        )
        r["u"].append(u)
        r["sel"].append(np.asarray(sel))
        r["trans"].append(np.asarray(tr))
        trans.append(tr)
    nbrs0s, stats = jsym.sym_pass(b, b_sq, nbrs0, None, nn1_stats, cfg, 0, E, TAU)
    r["sym0"] = (np.asarray(nbrs0s), stats)
    return r


@pytest.mark.parametrize("measure", [DistanceMeasure.Euclidean,
                                     DistanceMeasure.Cosine])
@pytest.mark.parametrize("layer", [0, 1])
def test_top_merge_matches(ref, layer, measure):
    base = ref["base"]
    cfg = ref["cfg"]
    trans = ref["trans"][layer] if layer else None
    b = jnp.asarray(base)
    want_i, want_nn1 = j_top_merge(
        b, j_squared_norms(b), None if trans is None else jnp.asarray(trans),
        cfg, layer, JMeasure(measure),
    )
    bt = _t(base)
    got_i, got_nn1 = top_merge_layer(
        bt, squared_norms(bt), None if trans is None else _t(trans),
        GraphConfig.create(N=N, D=D, KBuild=K), layer, measure,
    )
    _assert_ids_equal_up_to_near_ties(
        got_i.numpy(), np.asarray(want_i), base, trans, measure
    )
    # nn1 is the f32 expansion above, sqrt'ed: the summation order moves it
    # by up to ~1e-4 relative at this data's offset (|x|^2 ~ 1e6, d ~ 1e3)
    np.testing.assert_allclose(got_nn1.numpy(), np.asarray(want_nn1),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("layer", [0, 1])
def test_select_exact_given_uniforms(ref, layer):
    cfg = ref["cfg"]
    nn1 = ref["top0"][1] if layer == 0 else ref["top1"][1]
    trans = ref["trans"][layer] if layer else np.zeros((0,), np.int32)
    sel, tr = tselect._select(
        _t(ref["u"][layer]), _t(nn1), _t(trans), **_select_statics(cfg, layer)
    )
    np.testing.assert_array_equal(sel.numpy(), ref["sel"][layer + 1])
    np.testing.assert_array_equal(tr.numpy(), ref["trans"][layer + 1])


def test_select_generator_is_deterministic(ref):
    cfg = GraphConfig.create(N=N, D=D, KBuild=K)
    nn1 = _t(ref["top0"][1])
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        outs.append(tselect.wrs_select_layer(g, nn1, None, cfg, 0))
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    sel = outs[0][0].numpy()
    assert np.all(sel >= 0) and len(np.unique(sel)) == len(sel)


def test_rows_needing_walk_exact(ref):
    nbrs = ref["top0"][0]
    KL = ref["cfg"].KL
    want = np.asarray(jsym._rows_needing_walk(jnp.asarray(nbrs), KL=KL))
    got = tsym._rows_needing_walk(_t(nbrs), KL=KL, chunk=700)  # several chunks
    np.testing.assert_array_equal(got.numpy(), want)


def _random_requests(seed, R=600, Nl=300, KF=8):
    rng = np.random.default_rng(seed)
    pref = rng.integers(-1, Nl, size=(R, KF)).astype(np.int32)
    n_req = rng.integers(0, Nl, size=R).astype(np.int32)
    need = rng.random(R) < 0.7
    buf = np.where(rng.random((Nl, KF)) < 0.2, rng.integers(0, Nl, (Nl, KF)), -1)
    atomic = rng.integers(0, 3, size=Nl).astype(np.int32)
    return pref, n_req, need, buf.astype(np.int32), atomic


def test_insert_requests_exact():
    pref, n_req, need, buf, atomic = _random_requests(3)
    jb, ja, jacc = jsym._insert_requests(
        jnp.asarray(pref), jnp.asarray(n_req), jnp.asarray(need),
        jnp.asarray(buf), jnp.asarray(atomic), KF=8,
    )
    tb, ta = _t(buf), _t(atomic)
    tacc = tsym._insert_requests(_t(pref), _t(n_req), _t(need), tb, ta, KF=8)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))


def test_sym_buffer_merge_exact():
    rng = np.random.default_rng(4)
    Nl, KL, KF = 300, 8, 8
    nbrs = rng.integers(-1, Nl, size=(Nl, KL + KF)).astype(np.int32)
    buf = np.where(rng.random((Nl, KF)) < 0.4, rng.integers(0, Nl, (Nl, KF)), -1)
    buf = buf.astype(np.int32)
    atomic = rng.integers(0, KF + 3, size=Nl).astype(np.int32)
    want = np.asarray(jsym._sym_buffer_merge(
        jnp.asarray(nbrs), jnp.asarray(buf), jnp.asarray(atomic), KL=KL, KF=KF
    ))
    got = tsym._sym_buffer_merge(_t(nbrs), _t(buf), _t(atomic), KL=KL, KF=KF)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sym_pass_bulk_on_reference_input(ref, record_property):
    base = ref["base"]
    bt = _t(base)
    want, want_stats = ref["sym0"]
    got, stats = tsym.sym_pass(
        bt, squared_norms(bt), _t(ref["top0"][0]), None, _t(ref["nn1_stats"]),
        GraphConfig.create(N=N, D=D, KBuild=K), 0, DistanceMeasure.Euclidean, TAU,
    )
    got = got.numpy()
    KL = ref["cfg"].KL
    # the local links are the input's; the foreign half is the pass's work
    np.testing.assert_array_equal(got[:, :KL], want[:, :KL])
    overlap = _overlap(got[:, KL:], want[:, KL:])
    record_property("foreign_link_overlap", overlap)
    print(f"sym foreign-link overlap {overlap:.5f}; stats {stats} vs {want_stats}")
    assert overlap >= 0.99
    assert abs(stats["added_links"] - want_stats["added_links"]) <= 0.01 * N


def test_sym_pass_bulk_cosine(ref, record_property):
    """The cosine sym pass, fed the reference's cosine top-merge layer 0."""
    base = ref["base"]
    cfg = ref["cfg"]
    b = jnp.asarray(base)
    b_sq = j_squared_norms(b)
    nbrs, nn1 = j_top_merge(b, b_sq, None, cfg, 0, JMeasure.Cosine)
    nn1_stats = jnp.stack([jnp.mean(nn1), jnp.max(nn1)])
    want, want_stats = jsym.sym_pass(b, b_sq, nbrs, None, nn1_stats, cfg, 0,
                                     JMeasure.Cosine, TAU)
    bt = _t(base)
    got, stats = tsym.sym_pass(
        bt, squared_norms(bt), _t(nbrs), None, _t(nn1_stats),
        GraphConfig.create(N=N, D=D, KBuild=K), 0, DistanceMeasure.Cosine, TAU,
    )
    overlap = _overlap(got.numpy()[:, cfg.KL:], np.asarray(want)[:, cfg.KL:])
    record_property("foreign_link_overlap", overlap)
    print(f"cosine sym foreign-link overlap {overlap:.5f}")
    assert overlap >= 0.99
    assert abs(stats["added_links"] - want_stats["added_links"]) <= 0.01 * N


def test_merge_layer_on_reference_input(ref, record_property):
    """merge(1 -> 0) with dense seeding and the quantized layer-0 walk, fed
    the reference's post-sym layer 0, selection and translation."""
    base = ref["base"]
    cfg = ref["cfg"]
    nbrs0 = ref["sym0"][0]
    b = jnp.asarray(base)
    b_sq = j_squared_norms(b)
    scale, zero = jfused.fit_affine_u8(base)
    codes = jfused._encode_u8(b, jnp.asarray(scale), jnp.asarray(zero))
    x_hat_sq = j_squared_norms(codes.astype(jnp.float32) * scale + zero)
    adj = jfused.make_adjacency(codes, x_hat_sq, jnp.asarray(nbrs0),
                                jnp.asarray(scale), jnp.asarray(zero))
    empty = jnp.zeros((0,), jnp.int32)
    neighbors = tuple(
        jnp.asarray(nbrs0) if l == 0 else jnp.asarray(ref["top1"][0]) if l == 1
        else jnp.full((cfg.Ns[l], K), -1, jnp.int32) for l in range(cfg.L)
    )
    selection = (empty, jnp.asarray(ref["sel"][1]), empty, empty)
    translation = (empty, jnp.asarray(ref["trans"][1]), empty, empty)
    want_i, want_nn1 = j_merge_layer(
        b, b_sq, neighbors, selection, translation,
        jnp.asarray(ref["nn1_stats"]), cfg, 1, 0, JMeasure.Euclidean, TAU,
        adjs=(adj, None, None, None), use_pallas=False, dense_seed=True,
        num_seeds=32,
    )
    want_i, want_nn1 = np.asarray(want_i), np.asarray(want_nn1)

    bt = _t(base)
    t_scale, t_zero = quantizer_for(bt)
    t_codes, t_sq = encode_u8(bt, t_scale, t_zero)
    t_adj = make_adjacency(t_codes, t_sq, _t(nbrs0), t_scale, t_zero)
    t_empty = torch.zeros((0,), dtype=torch.int32)
    got_i, got_nn1 = merge_layer(
        bt, squared_norms(bt), tuple(_t(x) for x in neighbors),
        (t_empty, _t(ref["sel"][1]), t_empty, t_empty),
        (t_empty, _t(ref["trans"][1]), t_empty, t_empty), _t(ref["nn1_stats"]),
        GraphConfig.create(N=N, D=D, KBuild=K), 1, 0, DistanceMeasure.Euclidean,
        TAU, chunk=1024, adjs=(t_adj, None, None, None), dense_seed=True,
        num_seeds=32,
    )
    got_i, got_nn1 = got_i.numpy(), got_nn1.numpy()
    overlap = _overlap(got_i, want_i)
    same_rows = float(np.mean(np.all(got_i == want_i, axis=1)))
    record_property("merge_overlap", overlap)
    print(f"merge neighbour-set overlap {overlap:.5f}, identical rows {same_rows:.4f}")
    assert overlap >= 0.98
    assert np.mean(np.isclose(got_nn1, want_nn1, rtol=1e-4)) >= 0.98


def test_quantizer_codes_and_blocks_exact(ref):
    base = ref["base"]
    nbrs0 = ref["top0"][0]
    scale, zero = jfused.fit_affine_u8(base)
    codes = jfused._encode_u8(jnp.asarray(base), jnp.asarray(scale), jnp.asarray(zero))
    x_hat_sq = j_squared_norms(codes.astype(jnp.float32) * scale + zero)
    adj = jfused.make_adjacency(codes, x_hat_sq, jnp.asarray(nbrs0),
                                jnp.asarray(scale), jnp.asarray(zero))
    bt = _t(base)
    t_scale, t_zero = quantizer_for(bt)
    np.testing.assert_array_equal(t_scale.numpy(), scale)
    np.testing.assert_array_equal(t_zero.numpy(), zero)
    t_codes, t_sq = encode_u8(bt, t_scale, t_zero)
    np.testing.assert_array_equal(t_codes.numpy(), np.asarray(codes))
    t_adj = make_adjacency(t_codes, t_sq, _t(nbrs0), t_scale, t_zero)
    np.testing.assert_array_equal(t_adj.blocks.numpy(), np.asarray(adj.blocks))
    H = jfused._meta_half(K)
    meta = np.asarray(adj.meta)
    np.testing.assert_array_equal(t_adj.nbr_ids.numpy(), meta[:, :K])
    np.testing.assert_allclose(
        t_adj.nbr_sq.numpy(),
        np.ascontiguousarray(meta[:, H : H + K]).view(np.float32),
        rtol=1e-6,
    )


def _random_graph_arrays(cfg, seed):
    rng = np.random.default_rng(seed)
    nbrs = [rng.integers(-1, cfg.Ns[l], size=(cfg.Ns[l], cfg.KBuild)).astype(np.int32)
            for l in range(cfg.L)]
    sel = [np.zeros((0,), np.int32)] + [
        rng.integers(0, cfg.Ns[l - 1], size=cfg.Ns[l]).astype(np.int32)
        for l in range(1, cfg.L)
    ]
    trans = [np.zeros((0,), np.int32)] + [
        rng.integers(0, cfg.N, size=cfg.Ns[l]).astype(np.int32)
        for l in range(1, cfg.L)
    ]
    return nbrs, sel, trans, rng.random(2).astype(np.float32)


def _assert_graph_equal(a, b):
    for fa, fb in zip(a, b):
        if isinstance(fa, tuple):
            for x, y in zip(fa, fb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_npz_port_to_reference(tmp_path):
    cfg = GraphConfig.create(N=3000, D=32, KBuild=24)
    nbrs, sel, trans, nn1 = _random_graph_arrays(cfg, 1)
    g = tgraph.Graph(tuple(map(_t, nbrs)), tuple(map(_t, sel)),
                     tuple(map(_t, trans)), _t(nn1))
    tgraph.save_graph_shard(tmp_path / "part_0.npz", g, cfg)
    jg, jcfg = jgraph.load_graph_shard(tmp_path / "part_0.npz")
    assert jcfg.to_dict() == cfg.to_dict()
    _assert_graph_equal(tuple(x.numpy() if isinstance(x, torch.Tensor) else
                              tuple(y.numpy() for y in x) for x in g), jg)


def test_npz_reference_to_port(tmp_path):
    cfg = JGraphConfig.create(N=3000, D=32, KBuild=24)
    nbrs, sel, trans, nn1 = _random_graph_arrays(cfg, 2)
    jg = jgraph.Graph(tuple(map(jnp.asarray, nbrs)), tuple(map(jnp.asarray, sel)),
                      tuple(map(jnp.asarray, trans)), jnp.asarray(nn1))
    jgraph.save_graph_shard(tmp_path / "part_0.npz", jg, cfg)
    g, tcfg = tgraph.load_graph_shard(tmp_path / "part_0.npz")
    assert tcfg.to_dict() == cfg.to_dict()
    assert g.neighbors[0].dtype == torch.int32
    _assert_graph_equal(jax.device_get(jg), tuple(
        x.numpy() if isinstance(x, torch.Tensor) else tuple(y.numpy() for y in x)
        for x in g
    ))
