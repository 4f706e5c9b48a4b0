"""The port's headline benchmark ``bench_torch.py`` against the JAX
package's ``bench.py``, at a small size on the CPU.

``bench.py`` is read as source (``ast``), never imported: importing it
points JAX's persistent compile cache elsewhere for the whole worker.
"""

import ast
import functools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_torch as bt
import ggnn_tpu
from ggnn_torch import GGNN
from torch_reference import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
N, NQ, KB = 2048, 512, 24
SWEEP = bt.SWEEP[:2]


def _bench_py():
    return ast.parse((REPO / "bench.py").read_text())


def _bench_function(name):
    return next(n for n in _bench_py().body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _main_assign(name):
    """The value node of ``name = ...`` in bench.py's ``main``."""
    for node in ast.walk(_bench_function("main")):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name):
            return node.value
    raise LookupError(name)


def _run(*args, stats=None, **kw):
    """``bt.run``; closes the ``GGNN`` it leaves open in ``stats``."""
    result = bt.run(*args, stats=stats, **kw)
    if stats is not None:
        stats.pop("ggnn").close()
    return result


def _literal(node, **names):
    return eval(compile(ast.Expression(node), "bench.py", "eval"),
                {"__builtins__": {"max": max}}, names)


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """One run that builds N points on the CPU and stores its cache."""
    cache = tmp_path_factory.mktemp("bench_cache")
    stats = {}
    result = _run(N, NQ, KB, 1, "cpu", str(cache), False, True, sweep=SWEEP,
                  reps=1, stats=stats)
    return cache, result, stats


@pytest.mark.parametrize("n, nq, seed", [(300, 40, 0), (1000, 7, 3)])
def test_make_dataset_equals_bench_py(n, nq, seed):
    ns = {"np": np}
    exec(compile(ast.Module([_bench_function("make_dataset")], []), "bench.py",
                 "exec"), ns)
    want = ns["make_dataset"](n, nq, seed=seed)
    got = bt.make_dataset(n, nq, seed=seed)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        assert w.tobytes() == g.tobytes()


def test_sweep_knobs_and_baseline_equal_bench_py():
    k_query = _literal(_main_assign("k_query"))
    assert k_query == bt.K_QUERY
    assert _literal(_main_assign("qkw"), k_query=k_query) == bt.QKW
    assert _literal(_main_assign("sweep")) == bt.SWEEP
    assert _literal(_main_assign("max_iterations")) == bt.MAX_ITERATIONS
    assert _literal(_main_assign("tau_build")) == bt.TAU_BUILD
    baseline = next(n.value for n in _bench_py().body if isinstance(n, ast.Assign)
                    and n.targets[0].id == "BASELINE_QPS")
    assert _literal(baseline) == bt.BASELINE_QPS


def test_run_returns_bench_py_result_keys(stored):
    _, result, stats = stored
    want = _main_assign("result")
    top = [k.value for k in want.keys]
    detail = next(v for k, v in zip(want.keys, want.values) if k.value == "detail")
    # None: the ``**secondary`` entry, present only beside other caches
    detail_keys = {k.value for k in detail.keys if k is not None}
    assert list(result) == top
    assert set(result["detail"]) == detail_keys | {"device"}
    assert result["metric"] == "qps_c1_90" and result["unit"] == "queries/s"
    assert result["detail"]["device"] == "cpu"
    assert (result["detail"]["N"], result["detail"]["NQ"]) == (N, NQ)
    assert result["value"] > 0 and result["detail"]["c1"] >= 0.90
    assert [(p["tau"], p["iters"], p["P"]) for p in stats["points"]] == SWEEP
    assert json.loads(json.dumps(result)) == result
    assert not stats["cached"]


def _no_build(monkeypatch):
    class Rebuilt(Exception):
        pass

    def refuse(*args, **kw):
        raise Rebuilt

    monkeypatch.setattr(bt, "_build", refuse)
    return Rebuilt


def test_second_run_loads_the_cache(stored, monkeypatch):
    cache, first, first_stats = stored
    _no_build(monkeypatch)
    stats = {}
    result = _run(N, NQ, KB, 1, "cpu", str(cache), True, True, sweep=SWEEP,
                  reps=1, stats=stats)
    assert stats["cached"]
    assert result["detail"]["build_s"] == first["detail"]["build_s"]
    assert result["detail"]["build_cold_s"] == first["detail"]["build_cold_s"]
    # the same graph and queries: the same recall at every point (the best
    # point is the fastest qualifying one, which the clock decides)
    assert ([p["c1"] for p in stats["points"]]
            == [p["c1"] for p in first_stats["points"]])
    meta = json.loads((cache / "bench_meta.json").read_text())
    assert meta["package"] == "ggnn_torch"
    assert meta["build_version"] == bt.BUILD_PATH_VERSION
    assert meta["last_result"]["c1"] == result["detail"]["c1"]


@pytest.mark.parametrize("stale", ["k_build", "no_package", "jax_package",
                                   "build_version"])
def test_stale_cache_rebuilds(stored, tmp_path, monkeypatch, stale):
    cache = tmp_path / "cache"
    shutil.copytree(stored[0], cache)
    meta_path = cache / "bench_meta.json"
    meta = json.loads(meta_path.read_text())
    k_build = KB
    if stale == "k_build":
        k_build = KB // 2
    elif stale == "no_package":
        del meta["package"]
    elif stale == "jax_package":  # a meta as bench.py writes it
        del meta["package"]
        meta["build_version"] = 6
    else:
        meta["build_version"] = bt.BUILD_PATH_VERSION - 1
    meta_path.write_text(json.dumps(meta))
    rebuilt = _no_build(monkeypatch)
    with pytest.raises(rebuilt):
        _run(N, NQ, k_build, 1, "cpu", str(cache), False, True, sweep=SWEEP,
             reps=1)


def test_ground_truth_stored_per_query_count(stored, tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    shutil.copytree(stored[0], cache)
    _no_build(monkeypatch)
    assert sorted(p.name for p in cache.glob("gt_*.npy")) == [f"gt_{NQ}.npy"]
    stats = {}
    _run(N, 100, KB, 1, "cpu", str(cache), False, False, sweep=SWEEP[:1],
         reps=1, stats=stats)
    assert stats["cached"] and stats["gt_dists"] is not None  # computed anew
    gt = np.load(cache / "gt_100.npy")
    assert gt.shape == (100, 100)
    np.testing.assert_array_equal(gt, stats["gt_ids"])
    np.testing.assert_array_equal(np.load(cache / f"gt_{NQ}.npy"),
                                  stored[2]["gt_ids"])
    stats = {}
    _run(N, 100, KB, 1, "cpu", str(cache), False, False, sweep=SWEEP[:1],
         reps=1, stats=stats)
    assert stats["gt_dists"] is None  # read back
    np.testing.assert_array_equal(stats["gt_ids"], gt)


def test_jax_package_queries_the_stored_graph(stored):
    """The JAX package loads the graph and fused sidecar the port stored and
    queries every swept point with the same knobs: c@1 within 0.003."""
    cache, _, stats = stored
    base, query = stats["base"], stats["query"]
    g = ggnn_tpu.GGNN()
    g.set_base(base)
    g.set_working_directory(cache)
    g.load(KB)
    g.build_fused_index(group=1)
    evaluator = ggnn_tpu.Evaluator(base, query, stats["gt_ids"], k_query=bt.K_QUERY)
    for point in stats["points"]:
        ids, _ = g.query(query, bt.K_QUERY, point["tau"], point["iters"],
                         pops_per_iter=point["P"], use_pallas=False,
                         seed_approx=False, **bt.QKW)
        c1 = evaluator.evaluate_results(np.asarray(ids)).c1
        print(f"{point}: JAX package c@1 {c1}")
        assert abs(c1 - point["c1"]) <= 0.003


def test_error_in_a_sweep_point_propagates(stored, monkeypatch):
    """An error at the second sweep point ends the run: nothing is caught
    and skipped."""
    _no_build(monkeypatch)
    query_async = GGNN.query_async
    failing_iters = SWEEP[1][1]

    def failing(self, query, k_query, tau_query, max_iterations, **kw):
        if max_iterations == failing_iters:
            raise RuntimeError("sweep point failed")
        return query_async(self, query, k_query, tau_query, max_iterations, **kw)

    monkeypatch.setattr(GGNN, "query_async", failing)
    with pytest.raises(RuntimeError, match="sweep point failed"):
        _run(N, NQ, KB, 1, "cpu", str(stored[0]), False, True, sweep=SWEEP,
             reps=1)


def _script_env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("GGNN_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    env.update(extra)
    return env


def test_default_device_needs_a_card(tmp_path):
    """Without a CUDA device the default run fails before it makes data,
    and prints no result: it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench_torch.py")], cwd=tmp_path,
        env=_script_env(GGNN_BENCH_N="1024", GGNN_BENCH_NQ="10",
                        GGNN_BENCH_CACHE=""),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "qps_c1_90" not in proc.stdout


def test_bench_torch_imports_no_jax(tmp_path):
    code = ("import sys, bench_torch; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ggnn_tpu', 'bench')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=_script_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_main_on_the_cpu_prints_one_line_and_a_trace(tmp_path, monkeypatch,
                                                     capsys):
    """``main`` with the CPU asked for: one JSON result line on stdout, and
    with ``GGNN_PROFILE_DIR`` a Chrome trace of the run."""
    for name in [k for k in os.environ if k.startswith("GGNN_")]:
        monkeypatch.delenv(name)
    for name, value in (("DEVICE", "cpu"), ("N", "1024"), ("NQ", "64"),
                        ("K", "16"), ("WARM_BUILD", "0"),
                        ("CACHE", str(tmp_path / "cache"))):
        monkeypatch.setenv(f"GGNN_BENCH_{name}", value)
    monkeypatch.setenv("GGNN_PROFILE_DIR", str(tmp_path / "trace"))
    monkeypatch.setattr(bt, "run", functools.partial(bt.run, sweep=SWEEP[:1],
                                                     reps=1))
    bt.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["metric"] == "qps_c1_90" and result["detail"]["N"] == 1024
    assert result["detail"]["device"] == "cpu"
    assert (tmp_path / "cache" / "bench_meta.json").is_file()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
