"""``BENCHMARK.json`` and the files it names: every configuration, mix and
metric is found by name, and one dropped into another folder is picked up
with no code edit."""

import json
import re

import pytest

from annbench import harness, registry
from conftest import CHECKOUT, HERE, make_bench

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_benchmark_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["annbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for e in BENCH["configs"] + BENCH["workloads"] + METRICS]
    assert all(NAME.fullmatch(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert all(UNIT.fullmatch(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_is_found(cfg):
    found = registry.config(cfg["name"])
    assert (CHECKOUT / cfg["file"]) == registry.ROOT / "configs" / f"{cfg['name']}.json"
    assert found["name"] == cfg["name"]
    assert found["reduced"] == cfg["reduced"]
    for key in ("n_base", "dim", "k_build", "tau_build", "refinement_iterations",
                "engine", "k_query", "tau_query", "max_iterations",
                "pops_per_iter", "data", "limits", "source", "assumed"):
        assert key in found, key
    assert set(found["reduced"]) <= set(found)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(cell):
    assert cell["chips"] == 1
    assert registry.cell(BENCH, cell["name"]) is cell
    registry.config(cell["config"])
    mix = registry.traffic(cell["traffic"])
    assert harness.cycle(mix)
    for trace in (False, True):
        for m in registry.cell_metrics(BENCH, cell["name"], trace):
            assert callable(registry.metric_reader(m["name"]))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(registry.metric_reader(metric["name"]))


def test_files_dropped_elsewhere_are_picked_up(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = dict(registry.config("sift1m"), name="extra_cfg", n_base=2048)
    (tmp_path / "configs" / "extra_cfg.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "extra_mix.json").write_text(json.dumps(
        {"name": "extra_mix", "batch": 100, "pool": 250}))
    (tmp_path / "metrics" / "extra.calls.py").write_text(
        "def read(run):\n    return len(run.latencies)\n")
    roots = (tmp_path, registry.ROOT)
    bench = make_bench([["extra-cell", "extra_cfg", "extra_mix"]])
    bench["end_to_end"].append({"name": "extra.calls", "unit": "calls",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock"})
    assert registry.config("extra_cfg", roots)["n_base"] == 2048
    mix = registry.traffic("extra_mix", roots)
    assert harness.cycle(mix) == [(0, 100), (100, 100), (0, 100)]
    names = [m["name"] for m in registry.cell_metrics(bench, "extra-cell", False)]
    assert names[-1] == "extra.calls"
    read = registry.metric_reader("extra.calls", roots)
    assert read(harness.Run({}, {}, {}, latencies=[0.1, 0.2])) == 2
    # the package's own files stay reachable behind the extra folder
    assert registry.config("deep1m", roots)["name"] == "deep1m"


def test_the_closed_loop_wraps_at_the_end_of_the_pool():
    from annbench import data
    it = data.schedule({"batch": 30, "pool": 70})
    assert [next(it) for _ in range(4)] == [(0, 30), (30, 30), (0, 30), (30, 30)]
    with pytest.raises(ValueError):
        next(data.schedule({"batch": 2, "pool": 1}))


@pytest.mark.parametrize("bad", ["../configs/sift1m", "a/b", "", "x" * 65, "a b"])
def test_names_outside_the_alphabet_are_refused(bad):
    with pytest.raises(ValueError):
        registry.config(bad)


@pytest.mark.parametrize("key,value", [("measure", "inner_product"), ("measure", "l2"),
                                       ("precision", "uint8"), ("precision", "bfloat16")])
def test_a_measure_or_precision_the_harness_cannot_judge_fails_at_set_up(tmp_path, key, value):
    (tmp_path / "configs").mkdir()
    cfg = dict(registry.config("tiny", (HERE,)), name="odd_cfg", **{key: value})
    (tmp_path / "configs" / "odd_cfg.json").write_text(json.dumps(cfg))
    bench = make_bench([["odd-cell", "odd_cfg", "small"]])
    with pytest.raises(ValueError, match=f"^{key} {value!r}"):
        harness.run_cell(bench, "odd-cell", seed=7, seconds=0.1, trace=False,
                         roots=(tmp_path, HERE, registry.ROOT), device="cpu")
