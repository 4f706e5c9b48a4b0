"""Test-only cells of 65,536 points end to end on the card, untraced and
traced: the line parses and reads correct, under squared L2 and under
cosine on both engines; under cosine the control and every fault that
separates read not correct. Run on the card with ``python -m pytest
annbench/tests -m cuda``."""

import json

import pytest
import torch

from annbench import control, data, faults, harness, reference, registry
from conftest import ROOTS, make_bench

BENCH = make_bench([["tiny65k-fused", "tiny65k", "t10k"],
                    ["tiny65k-cos-fused", "tiny65k_cos", "t10k"],
                    ["tiny65k-cos-row", "tiny65k_cos_row", "t10k"]])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _line(card, cell, trace, seed):
    out, _ = harness.run_cell(BENCH, cell, seed=seed, seconds=2.0, trace=trace,
                              roots=ROOTS, device=card)
    line = json.loads(json.dumps(out))
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(card)
    assert line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    else:
        assert line["metrics"]["qps"]["value"] > 0
    return line


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_on_the_card(card, trace):
    line = _line(card, "tiny65k-fused", trace, 2**31 + 4242)
    if trace:
        assert {"device.idle_share", "fused.walk_ms_per_kq",
                "approx_topk_roofline"} <= set(line["metrics"])
        assert 0 < line["metrics"]["approx_topk_roofline"]["value"] <= 105


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny65k-cos-fused", "tiny65k-cos-row"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_cosine_cell_on_the_card(card, cell, trace):
    line = _line(card, cell, trace, 2**31 + 4343)
    if trace:
        walk = "fused.walk_ms_per_kq" if cell.endswith("fused") else "row.walk_ms_per_kq"
        assert {"device.idle_share", "walk.replays_per_call", walk} <= set(line["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny65k_cos", "tiny65k_cos_row"])
def test_the_cosine_control_and_faults_read_not_correct_on_the_card(card, name):
    """The control, and every fault of ``faults.py`` but ``fixed_seeds``
    (which the walk recovers from, as on sift1m and gist1m), read not
    correct; the sound program reads correct on the same build."""
    cfg, mix = registry.config(name, ROOTS), registry.traffic("t10k", ROOTS)
    seed = 2**31 + 4444
    assert not reference.passed(control.control_checks(cfg, mix, seed, card))
    base, pool = data.generate(cfg["data"], int(cfg["n_base"]), int(cfg["dim"]),
                               int(mix["pool"]), seed, card)
    g, _ = harness.build_program(cfg, base, card)
    gt = reference.exact_knn(base, pool, harness.RECALL_K,
                             measure=cfg["measure"])[0].cpu().numpy()
    try:
        read = dict(faults.readings(g, cfg, mix, base, pool, gt))
    finally:
        g.close()
    assert reference.passed(read.pop("sound"))
    read.pop("fixed_seeds", None)
    assert len(read) == 4
    assert [f for f, checks in read.items() if reference.passed(checks)] == []
