"""Finds what ``BENCHMARK.json`` names, by name, as files.

* a configuration ``<name>``: ``configs/<name>.json``;
* a traffic mix ``<name>``: ``traffic/<name>.json``;
* a metric ``<name>``: ``metrics/<name>.py``, a module with one function
  ``read(run)`` that returns the metric's value from a finished run, or
  None where the run holds nothing for it to read.

Each is looked up in a list of root directories, in order, this
package's own by default: a cell, a configuration, a mix or a metric is
added by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

__all__ = ["ROOT", "ROOTS", "cell", "cell_metrics", "config", "load_bench",
           "metric_reader", "traffic"]

ROOT = Path(__file__).resolve().parent
ROOTS = (ROOT,)
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    with open(path) as f:
        return json.load(f)


def _find(roots, folder: str, name: str, suffix: str) -> Path:
    """The first ``<root>/<folder>/<name><suffix>`` of ``roots`` that exists."""
    rel = Path(folder) / f"{_checked(name)}{suffix}"
    for r in roots:
        if (Path(r) / rel).is_file():
            return Path(r) / rel
    raise FileNotFoundError(f"no {rel} under {', '.join(map(str, roots))}")


def load_bench(checkout: Path) -> dict:
    """``BENCHMARK.json`` at the root of ``checkout``."""
    return _json(Path(checkout) / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    """The workload entry called ``name``."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, roots=ROOTS) -> dict:
    return _json(_find(roots, "configs", name, ".json"))


def traffic(name: str, roots=ROOTS) -> dict:
    return _json(_find(roots, "traffic", name, ".json"))


def metric_reader(name: str, roots=ROOTS):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = _find(roots, "metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        "annbench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, name: str, trace: bool) -> list:
    """The metric entries a run of cell ``name`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced. A metric with a
    ``workloads`` key belongs to the cells it lists; without one, an
    end-to-end metric to every cell and a per-layer metric to every cell
    that reports the end-to-end metric it ``moves``."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
