"""Whole runs on the CPU at a tiny size, past the harness's look for a
card: the result line's form, a sound run read as correct, and the
control and each fault a cell can have read as not correct, under both
measures and on both engines."""

import json
import re

import numpy as np
import pytest
import torch

from annbench import control, data, faults, harness, reference, registry
from conftest import ROOTS, make_bench

CELLS = [["tiny-fused", "tiny", "small"], ["tiny-row", "tiny_row", "small"],
         ["tiny-cos-fused", "tiny_cos", "small"], ["tiny-cos-row", "tiny_cos_row", "small"]]
CELL_NAMES = [c for c, _, _ in CELLS]
BENCH = make_bench(CELLS)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SEED = 2**31 + 977


def run(cell, trace=False, tamper=None, seed=SEED):
    out, checks = harness.run_cell(BENCH, cell, seed=seed, seconds=0.3, trace=trace,
                                   roots=ROOTS, device="cpu", tamper=tamper)
    return json.loads(json.dumps(out)), checks


@pytest.fixture(scope="module")
def sound():
    return {(c, t): run(c, t) for c in CELL_NAMES for t in (False, True)}


@pytest.mark.parametrize("cell", CELL_NAMES)
@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(sound, cell, trace):
    out, checks = sound[(cell, trace)]
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"] == checks and list(checks) == list(reference.CHECKS)
    names = [m["name"] for m in registry.cell_metrics(BENCH, cell, trace)]
    assert set(out["metrics"]) <= set(names)
    if not trace:
        assert list(out["metrics"]) == names
    for name, m in out["metrics"].items():
        assert NAME.fullmatch(name) and UNIT.fullmatch(m["unit"])
        assert list(m) == ["value", "unit"] and isinstance(m["value"], float)
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["window_s"] > 0 and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in out["breakdown"].values())


def test_the_seed_fixes_the_data():
    cfg, mix = registry.config("tiny", ROOTS), registry.traffic("small", ROOTS)
    a = data.generate(cfg["data"], 512, 32, 64, SEED, "cpu")
    b = data.generate(cfg["data"], 512, 32, 64, SEED, "cpu")
    c = data.generate(cfg["data"], 512, 32, 64, SEED + 1, "cpu")
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == c[0]).all()
    assert float(a[0].min()) >= 0 and float(a[0].max()) <= 255
    assert mix["pool"] == 1024


@pytest.mark.parametrize("cell,cfg_name", [(c, cfg) for c, cfg, _ in CELLS])
def test_the_control_reads_not_correct(sound, cell, cfg_name):
    cfg, mix = registry.config(cfg_name, ROOTS), registry.traffic("small", ROOTS)
    checks = control.control_checks(cfg, mix, SEED, "cpu")
    assert not reference.passed(checks)
    program = sound[(cell, False)][1]["dist_gap"]["value"]
    assert checks["dist_gap"]["value"] > 3 * checks["dist_gap"]["limit"] > 3 * program


@pytest.mark.parametrize("cell", CELL_NAMES)
@pytest.mark.parametrize("fault", ["an answer altered", "half the batch left out"])
def test_each_fault_reads_not_correct(cell, fault):
    tamper = (faults.altered_answer(4096) if fault == "an answer altered"
              else faults.half_batch)
    out, checks = run(cell, tamper=tamper)
    assert out["correct"] is False
    assert checks["dist_gap"]["value"] > checks["dist_gap"]["limit"]


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_a_step_that_returns_its_state_unchanged_reads_not_correct(cell):
    with faults.step_unchanged():
        out, checks = run(cell)
    assert out["correct"] is False
    # the walk found too few of the true neighbours, whatever else reads
    assert checks["recall_miss"]["value"] > 3 * checks["recall_miss"]["limit"]


@pytest.mark.parametrize("cfg_name", [cfg for _, cfg, _ in CELLS])
def test_every_fault_of_the_faults_tool_reads_not_correct(cfg_name):
    """``faults.readings`` on one build: ``sound`` passes, and every fault
    but ``fixed_seeds`` fails. Seeds fixed at the first representatives
    leave the walk to find the neighbours, and read correct here as on
    the card's sift1m and gist1m."""
    cfg, mix = registry.config(cfg_name, ROOTS), registry.traffic("small", ROOTS)
    base, pool = data.generate(cfg["data"], int(cfg["n_base"]), int(cfg["dim"]),
                               int(mix["pool"]), SEED, "cpu")
    g, _ = harness.build_program(cfg, base, torch.device("cpu"))
    gt = reference.exact_knn(base, pool, harness.RECALL_K,
                             measure=cfg["measure"])[0].numpy()
    try:
        read = dict(faults.readings(g, cfg, mix, base, pool, gt))
    finally:
        g.close()
    assert list(read) == list(faults.plans(cfg))
    assert ("fixed_seeds" in read) == (cfg["engine"] == "fused")
    assert reference.passed(read.pop("sound"))
    read.pop("fixed_seeds", None)
    assert [f for f, checks in read.items() if reference.passed(checks)] == []


@pytest.mark.parametrize("measure", ["euclidean", "cosine"])
def test_the_fixed_seeds_stand_in_gives_true_distances_under_the_measure(measure):
    """The planted fault changes the choice of seeds only: their distances
    are the reference's, under the run's measure."""
    from ggnn_torch import DistanceMeasure
    from ggnn_torch.query import fused

    cfg = registry.config("tiny_cos", ROOTS)
    reps, q = data.generate(cfg["data"], 300, 32, 40, SEED, "cpu")
    with faults.fixed_seeds():
        d, pos = fused.dist_approx_smallest_k(
            q, reps, 8, DistanceMeasure.parse(measure), q_sq=(q * q).sum(1),
            c_sq=(reps * reps).sum(1))
    assert (pos == torch.arange(8, dtype=torch.int32)).all()
    want = reference.pair_dists(reps, q, pos.long(), measure=measure)
    scale = want.clamp_min(float(want.median()))
    assert float(((d.double() - want).abs() / scale).max()) < 1e-5


@pytest.mark.parametrize("name", ["tiny_cos", "tiny_cos_row"])
def test_the_cosine_configurations_rank_otherwise_than_l2(name):
    """Their data is not of unit norm, so the exact nearest under cosine
    are not those under squared L2."""
    cfg, mix = registry.config(name, ROOTS), registry.traffic("small", ROOTS)
    base, pool = data.generate(cfg["data"], int(cfg["n_base"]), int(cfg["dim"]),
                               int(mix["pool"]), SEED, "cpu")
    cos = reference.exact_knn(base, pool, 10, measure="cosine")[0].numpy()
    l2 = reference.exact_knn(base, pool, 10)[0].numpy()
    assert cfg["measure"] == "cosine" and not cfg["data"]["normalize"]
    assert reference.recall_hits(cos, l2).mean() < 0.8 * 10
