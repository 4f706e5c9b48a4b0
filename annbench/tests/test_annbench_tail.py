"""The glove100 configuration, its cell and the tail kernels' metrics: each
reader on canned trace events and a canned anchor count gives its value,
and nothing where the run holds nothing to read; the wide kernel's
roofline reads as before where the count also holds tail keys.

On the card (marker ``cuda``) a test-only cell of 65,536 points at
glove100's data model and 100 dims (cosine, the tail adjacency kernels)
runs untraced and traced, reads correct and reports the tail metrics; its
control and every fault that separates read not correct:
``python -m pytest annbench/tests -m cuda``."""

import json

import pytest
import torch

from annbench import control, data, faults, harness, reference, registry, tracing
from annbench.counts import adjacency_dot as counts
from conftest import ROOTS, make_bench

TAIL = "adjacency_dot_u8_tail_t32"
TAIL_WIDE = "adjacency_dot_u8_tail_wide"
ADJ_T8 = "adjacency_dot_u8_t8"
ADJ_WIDE = "adjacency_dot_u8_wide"
GLOVE = registry.config("glove100")
GIST = registry.config("gist1m")


def _run(kernels, queries=20000, cfg=GLOVE):
    """A run whose trace holds ``kernels``: (name, us, grid rows)."""
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10.0 * k, "dur": us,
               "args": {"grid": [rows, 2, 1]}}
              for k, (n, us, rows) in enumerate(kernels)]
    return harness.Run({}, cfg, {}, trace=tracing.Trace(events, calls=2,
                                                        queries=queries))


def test_registry_finds_the_configuration_and_the_cell():
    assert GLOVE["n_base"] == 1_183_514 and GLOVE["dim"] == 100
    assert GLOVE["measure"] == "cosine" and GLOVE["precision"] == "float32"
    assert GLOVE["reduced"] == [] and GLOVE["engine"] == "fused"
    assert GLOVE["published"] == {"n_base": 1_183_514, "dim": 100, "queries": 10_000}
    assert GLOVE["dim"] % 16 and GLOVE["dim"] % 4 == 0
    assert not GLOVE["data"]["normalize"]
    bench = registry.load_bench(registry.ROOT.parent)
    cell = registry.cell(bench, "glove100-fused-b10k")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("glove100", "b10k", 1)
    names = {m["name"] for m in registry.cell_metrics(bench, "glove100-fused-b10k", True)}
    assert {"adjacency_dot.tail_ms_per_kq", "adjacency_dot.tail_roofline",
            "fused.walk_ms_per_kq", "build.quantize_s"} <= names
    assert not names & {"adjacency_dot.wide_roofline", "adjacency_dot.wide_ms_per_kq"}
    for other in ("sift1m-fused-b10k", "gist1m-fused-b1k"):
        assert "adjacency_dot.tail_roofline" not in {
            m["name"] for m in registry.cell_metrics(bench, other, True)}


def test_tail_ms_per_kq():
    read = registry.metric_reader("adjacency_dot.tail_ms_per_kq")
    run = _run([(TAIL, 300.0, 8192), (ADJ_T8, 500.0, 8192), (ADJ_WIDE, 50.0, 8192),
                ("adjacency_dot_int4_tail_t8", 100.0, 2048), (TAIL_WIDE, 200.0, 512)])
    assert read(run) == pytest.approx(0.6 / 20.0)
    assert read(_run([(ADJ_T8, 500.0, 8192), (ADJ_WIDE, 9.0, 8)])) is None
    assert read(harness.Run({}, {}, {})) is None


def test_tail_roofline_reads_the_programs_anchor_count(monkeypatch):
    from ggnn_torch.ops import adjacency

    read = registry.metric_reader("adjacency_dot.tail_roofline")
    anchors = {("u8_tail", 32, False): 600_000, ("u8", 8, False): 10**9,
               ("u8", 32, True): 10**9, ("int4_tail", 32, False): 10**9}
    monkeypatch.setattr(adjacency, "fetched_anchors", lambda: dict(anchors))
    run = _run([(TAIL, 400.0, 8192), (TAIL, 100.0, 2048), (ADJ_T8, 999.0, 8192)])
    nbytes = counts.adjacency_bytes(600_000, 10240, GLOVE["pops_per_iter"], 24, 100)
    assert read(run) == pytest.approx(100.0 * counts.bytes_ms(nbytes) / 0.5)
    # D = 100 bytes a code row, as the configuration states it
    assert nbytes == 600_000 * (24 * 100 + 24 * 4) + 10240 * (100 * 4 + 8 * 4)
    # no tail launch, no tail count, or no counter in the program: nothing
    assert read(_run([(ADJ_T8, 999.0, 8192)])) is None
    del anchors[("u8_tail", 32, False)]
    assert read(run) is None
    monkeypatch.delattr(adjacency, "fetched_anchors")
    assert read(run) is None
    assert read(harness.Run({}, GLOVE, {})) is None


def test_wide_roofline_reads_as_before_beside_tail_keys(monkeypatch):
    """A gist-shaped count with tail keys beside it: the wide kernel's
    share counts its own anchors only, as before the tail keys existed."""
    from ggnn_torch.ops import adjacency

    read = registry.metric_reader("adjacency_dot.wide_roofline")
    run = _run([(ADJ_WIDE, 40.0, 1024), (ADJ_WIDE, 60.0, 512), (TAIL_WIDE, 999.0, 1024),
                (TAIL, 999.0, 1024)], queries=2000, cfg=GIST)
    want = 100.0 * counts.bytes_ms(counts.adjacency_bytes(
        8000, 1536, GIST["pops_per_iter"], 24, 960)) / 0.1
    before = {("u8", 32, True): 8000, ("u8", 8, False): 10**9}
    monkeypatch.setattr(adjacency, "fetched_anchors", lambda: dict(before))
    assert read(run) == pytest.approx(want)
    with_tail = {**before, ("u8_tail", 32, True): 10**9,
                 ("u8_tail", 32, False): 10**9}
    monkeypatch.setattr(adjacency, "fetched_anchors", lambda: dict(with_tail))
    assert read(run) == pytest.approx(want)


BENCH = make_bench([["tiny65k-glove-fused", "tiny65k_glove", "t10k"]])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_glove_cell_on_the_card(card, trace):
    out, _ = harness.run_cell(BENCH, "tiny65k-glove-fused", seed=2**31 + 100,
                              seconds=2.0, trace=trace, roots=ROOTS, device=card)
    line = json.loads(json.dumps(out))
    assert line["correct"] is True and line["failed"] == 0
    metrics = line["metrics"]
    if not trace:
        assert metrics["qps"]["value"] > 0
        return
    assert {"device.idle_share", "walk.replays_per_call",
            "fused.walk_ms_per_kq"} <= set(metrics)
    assert "adjacency_dot.wide_roofline" not in metrics
    assert metrics["adjacency_dot.tail_ms_per_kq"]["value"] > 0
    assert 0 < metrics["adjacency_dot.tail_roofline"]["value"] <= 105


@pytest.mark.cuda
def test_the_glove_control_and_faults_read_not_correct_on_the_card(card):
    """The control, and every fault of ``faults.py`` but ``fixed_seeds``
    (which the walk recovers from), read not correct; the sound program
    reads correct on the same build, whose merges walked the codes."""
    cfg, mix = registry.config("tiny65k_glove", ROOTS), registry.traffic("t10k", ROOTS)
    seed = 2**31 + 4545
    assert not reference.passed(control.control_checks(cfg, mix, seed, card))
    base, pool = data.generate(cfg["data"], int(cfg["n_base"]), int(cfg["dim"]),
                               int(mix["pool"]), seed, card)
    g, _ = harness.build_program(cfg, base, card)
    gt = reference.exact_knn(base, pool, harness.RECALL_K,
                             measure=cfg["measure"])[0].cpu().numpy()
    try:
        fetch = g.last_build_stats["shards"][0]["merge_fetch"]
        read = dict(faults.readings(g, cfg, mix, base, pool, gt))
    finally:
        g.close()
    assert fetch["quantized"] > 0 and fetch["f32"] == 0
    assert reference.passed(read.pop("sound"))
    read.pop("fixed_seeds", None)
    assert len(read) == 4
    assert [f for f, checks in read.items() if reference.passed(checks)] == []
