"""The gist1m configuration, the b1k and b100 mixes, and the wide kernels'
metrics: each reader on canned trace events gives its value, and nothing
where the run holds nothing to read; the adjacency kernel's byte count at
a known shape. On the card (marker ``cuda``) a test-only cell of 65,536
points at 960 dims runs traced end to end and its line reads the wide
kernels' metrics: ``python -m pytest annbench/tests -m cuda``."""

import json

import pytest
import torch

from annbench import harness, registry, tracing
from annbench.counts import adjacency_dot as counts
from conftest import ROOTS, make_bench

ADJ_WIDE = "adjacency_dot_u8_wide"
ADJ_T8 = "adjacency_dot_u8_t8"
GATHER_4 = ("void (anonymous namespace)::gather_dist_kernel<1, 4, false, true>"
            "(float const*, long long, long long, float const*, int const*)")
GATHER_1 = ("void (anonymous namespace)::gather_dist_kernel<1, 1, false, true>"
            "(float const*, long long, long long, float const*, int const*)")
GIST = registry.config("gist1m")


def _run(kernels, queries=2000, cfg=GIST):
    """A run whose trace holds ``kernels``: (name, us, grid rows)."""
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10.0 * k, "dur": us,
               "args": {"grid": [rows, 2, 1]}}
              for k, (n, us, rows) in enumerate(kernels)]
    return harness.Run({}, cfg, {}, trace=tracing.Trace(events, calls=2,
                                                        queries=queries))


def test_registry_finds_the_configuration_and_the_mixes():
    assert GIST["n_base"] == 1_000_000 and GIST["dim"] == 960
    assert GIST["reduced"] == [] and GIST["engine"] == "fused"
    assert registry.traffic("b1k")["batch"] == 1000
    assert registry.traffic("b100")["batch"] == 100
    bench = registry.load_bench(registry.ROOT.parent)
    assert registry.cell(bench, "gist1m-fused-b1k")["config"] == "gist1m"
    assert registry.cell(bench, "sift1m-fused-b100")["traffic"] == "b100"
    names = {m["name"] for m in registry.cell_metrics(bench, "gist1m-fused-b1k", True)}
    assert {"adjacency_dot.wide_ms_per_kq", "adjacency_dot.wide_roofline",
            "gather_dist.wide_ms_per_kq"} <= names


def test_wide_adjacency_ms_per_kq():
    read = registry.metric_reader("adjacency_dot.wide_ms_per_kq")
    run = _run([(ADJ_WIDE, 300.0, 1024), (ADJ_T8, 500.0, 1024),
                ("adjacency_dot_int4_wide", 100.0, 1024)])
    assert read(run) == pytest.approx(0.4 / 2.0)
    assert read(_run([(ADJ_T8, 500.0, 1024)])) is None
    assert read(harness.Run({}, {}, {})) is None


def test_wide_gather_ms_per_kq():
    read = registry.metric_reader("gather_dist.wide_ms_per_kq")
    run = _run([(GATHER_4, 250.0, 128), (GATHER_1, 999.0, 128),
                ("void (anonymous namespace)::gather_dist_kernel<2, 4, true, true>(int)",
                 150.0, 64)], queries=1000)
    assert read(run) == pytest.approx(0.4)
    assert read(_run([(GATHER_1, 999.0, 128)])) is None
    assert read(harness.Run({}, {}, {})) is None


def test_adjacency_bytes_at_a_known_shape():
    # 10 anchors of 24 x 960-byte blocks, each writing 24 f32 dots; 4 query
    # rows of 960 f32 and 8 anchor ids
    want = 10 * (24 * 960 + 24 * 4) + 4 * (960 * 4 + 8 * 4)
    assert counts.adjacency_bytes(10, 4, 8, 24, 960) == want
    # int4: two dots a code row
    assert counts.adjacency_bytes(10, 4, 8, 12, 960, nibbles=True) == (
        10 * (12 * 960 + 24 * 4) + 4 * (960 * 4 + 8 * 4))
    assert counts.bytes_ms(3.35e9) == pytest.approx(1.0)


def test_wide_roofline_reads_the_programs_anchor_count(monkeypatch):
    from ggnn_torch.ops import adjacency

    read = registry.metric_reader("adjacency_dot.wide_roofline")
    anchors = {("u8", 32, True): 8000, ("u8", 8, False): 10**9,
               ("int4", 32, True): 10**9}
    monkeypatch.setattr(adjacency, "fetched_anchors", lambda: dict(anchors))
    run = _run([(ADJ_WIDE, 40.0, 1024), (ADJ_WIDE, 60.0, 512),
                (ADJ_T8, 999.0, 1024)])
    nbytes = counts.adjacency_bytes(8000, 1536, GIST["pops_per_iter"], 24, 960)
    assert read(run) == pytest.approx(100.0 * counts.bytes_ms(nbytes) / 0.1)
    # no wide launch, no count, or no counter in the program: nothing
    assert read(_run([(ADJ_T8, 999.0, 1024)])) is None
    anchors.clear()
    assert read(run) is None
    monkeypatch.delattr(adjacency, "fetched_anchors")
    assert read(run) is None
    assert read(harness.Run({}, GIST, {})) is None


@pytest.mark.cuda
def test_a_tiny_wide_cell_on_the_card():
    """960 dims (gist1m's data model): the wide adjacency kernel and the
    gather + distance's four-slab instance run, and their metrics read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench = make_bench([["tiny960-fused", "tiny960", "b1k"]])
    out, _ = harness.run_cell(bench, "tiny960-fused", seed=2**31 + 960, seconds=2.0,
                              trace=True, roots=ROOTS, device=torch.device("cuda"))
    line = json.loads(json.dumps(out))
    assert line["correct"] is True and line["failed"] == 0
    metrics = line["metrics"]
    assert {"adjacency_dot.wide_ms_per_kq", "adjacency_dot.wide_roofline",
            "gather_dist.wide_ms_per_kq"} <= set(metrics)
    assert metrics["adjacency_dot.wide_ms_per_kq"]["value"] > 0
    assert 0 < metrics["adjacency_dot.wide_roofline"]["value"] <= 105
