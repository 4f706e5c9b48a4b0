"""Fixtures of the benchmark's tests: a benchmark of test-only cells over
the configurations and mixes in this folder, and few CPU threads."""

import json
from pathlib import Path

import pytest
import torch

from annbench import registry

HERE = Path(__file__).resolve().parent
CHECKOUT = registry.ROOT.parent
# test-only files first, then the benchmark's own
ROOTS = (HERE, registry.ROOT)


def make_bench(cells) -> dict:
    """``BENCHMARK.json`` with ``cells`` ([name, config, traffic]) in place
    of its workloads, every per-layer metric reported in each."""
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                           "why": "test"} for n, c, t in cells]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    return bench


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
