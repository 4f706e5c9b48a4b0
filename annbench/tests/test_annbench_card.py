"""A test-only cell of 65,536 points end to end on the card, untraced and
traced: the line parses and reads correct. Run on the card with
``python -m pytest annbench/tests -m cuda``."""

import json

import pytest
import torch

from annbench import harness
from conftest import ROOTS, make_bench

BENCH = make_bench([["tiny65k-fused", "tiny65k", "t10k"]])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_on_the_card(card, trace):
    out, _ = harness.run_cell(BENCH, "tiny65k-fused", seed=2**31 + 4242, seconds=2.0,
                              trace=trace, roots=ROOTS, device=card)
    line = json.loads(json.dumps(out))
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(card)
    assert line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert {"device.idle_share", "fused.walk_ms_per_kq",
                "approx_topk_roofline"} <= set(line["metrics"])
        assert 0 < line["metrics"]["approx_topk_roofline"]["value"] <= 105
    else:
        assert line["metrics"]["qps"]["value"] > 0
