"""One run of a cell: set-up, the measured window, the traced calls, the
reference's judgement and the result line.

Set-up draws the base and the query pool from the seed on the device,
builds the program's kernels (only the first run in a checkout compiles
them), builds the index through ``GGNN.set_base`` and ``GGNN.build`` (and
``build_fused_index`` for the fused engine), and runs every call of one
cycle of the mix over the pool, so that every tile shape and every walk
program the window uses exists before it opens. The window calls
``GGNN.query`` as the mix says, with host results, until ``seconds``
have passed. A traced run then runs a few more calls under
``torch.profiler``. Once the calls are done the device's peak memory is
read and the program is freed; then the reference computes the exact
nearest neighbours of the pool and judges every answer.
"""

from __future__ import annotations

import gc
import itertools
import json
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from annbench import data, reference, registry, tracing

__all__ = ["Run", "build_program", "cycle", "query_fn", "run_cell"]

# calls under the profiler in a traced run, after one warm-up call
TRACE_CALLS = 16
# the exact nearest neighbours that ``recall_at_10`` looks for
RECALL_K = 10


@dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: dict
    config: dict
    traffic: dict
    latencies: list = field(default_factory=list)  # s a call, in the window
    queries: int = 0                                # answered in the window
    window_s: float = 0.0
    recall: float | None = None
    build_s: float = 0.0
    setup_s: float = 0.0
    phases: dict = field(default_factory=dict)
    trace: tracing.Trace | None = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prepare_kernels(device: torch.device) -> None:
    """Build (first run) or find (every later run) the program's kernel
    libraries, so that no compiler runs inside a timed stretch."""
    if device.type != "cuda":
        return
    from ggnn_torch.ops import adjacency, approx_topk, beam, gather_dist

    for op in (adjacency, approx_topk, beam, gather_dist):
        op.build_kernel()


def cycle(traffic: dict) -> list:
    """One cycle of the mix: the calls, (first pool row, rows), that ask
    every pool row at least once."""
    it = data.schedule(traffic)
    out, rows = [], 0
    while rows < int(traffic["pool"]):
        lo, n = next(it)
        out.append((lo, n))
        rows += n
    return out


def _power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def _answers(calls):
    """The answers to judge: each (first row, rows) position's first answer
    whole, and the rows of a later answer at that position that differ
    from it. Returns (their pool rows, ids, dists, the first answer of each
    position, per call: (its position, the rows that differ or None for a
    first answer))."""
    canon, rows_l, ids_l, dists_l, per_call = {}, [], [], [], []
    for lo, n, ids, dists in calls:
        key = (lo, n)
        if key not in canon:
            canon[key] = (ids, dists)
            rows_l.append(np.arange(lo, lo + n))
            ids_l.append(ids)
            dists_l.append(dists)
            per_call.append((key, None))
            continue
        c_ids, c_dists = canon[key]
        diff = np.nonzero((ids != c_ids).any(1) | (dists != c_dists).any(1))[0]
        if len(diff):
            rows_l.append(lo + diff)
            ids_l.append(ids[diff])
            dists_l.append(dists[diff])
        per_call.append((key, diff))
    return (np.concatenate(rows_l), np.concatenate(ids_l),
            np.concatenate(dists_l), canon, per_call)


def _recall(calls, canon, per_call, gt: np.ndarray, k: int) -> float:
    """The share of the exact ``k`` nearest (``gt [pool, k]``) returned,
    over every answer of ``calls``."""
    canon_hits = {key: reference.recall_hits(ids, gt[key[0] : key[0] + key[1]])
                  for key, (ids, _) in canon.items()}
    hits = rows = 0
    for (lo, n, ids, _), (key, diff) in zip(calls, per_call):
        h = canon_hits[key]
        total = int(h.sum())
        if diff is not None and len(diff):
            total += int(reference.recall_hits(ids[diff], gt[lo + diff]).sum()
                         - h[diff].sum())
        hits += total
        rows += n
    return hits / (rows * k)


def build_program(cfg: dict, base: torch.Tensor, device: torch.device):
    """The system under test over ``base``: a ``GGNN`` built as the
    configuration says, under its ``measure``, with its fused index where
    its engine is the fused one. Returns (the ``GGNN``, the build's
    seconds). A ``measure`` the reference does not know, or a
    ``precision`` other than the f32 that ``data.generate`` draws, raises
    a ``ValueError`` that names the key."""
    from ggnn_torch import GGNN, DistanceMeasure

    if cfg["measure"] not in reference.MEASURES:
        raise ValueError(f"measure {cfg['measure']!r}: the harness runs "
                         f"{', '.join(reference.MEASURES)}")
    if cfg["precision"] != "float32":
        raise ValueError(f"precision {cfg['precision']!r}: the harness hands "
                         "the program a float32 base only")
    _prepare_kernels(device)
    g = GGNN(device=device)
    g.set_base(base)
    _sync(device)
    t0 = time.perf_counter()
    g.build(k_build=int(cfg["k_build"]), tau_build=float(cfg["tau_build"]),
            refinement_iterations=int(cfg["refinement_iterations"]),
            measure=DistanceMeasure.parse(cfg["measure"]))
    _sync(device)
    build_s = time.perf_counter() - t0
    if cfg["engine"] == "fused":
        g.build_fused_index(group=int(cfg["group"]), bits=int(cfg["bits"]))
    return g, build_s


def query_fn(g, cfg: dict, pool: torch.Tensor, point=None, tamper=None):
    """``call(first row, rows) -> (ids, dists)``: one ``GGNN.query`` of those
    pool rows at the configuration's operating point (or at ``point``,
    (tau_query, max_iterations, pops_per_iter)), host results."""
    tau, iters, pops = point or (cfg["tau_query"], cfg["max_iterations"],
                                 cfg["pops_per_iter"])
    args = (int(cfg["k_query"]), float(tau), int(iters))
    kw = dict(cfg.get("engine_kwargs", {}), pops_per_iter=int(pops))
    engine = cfg["engine"]

    def call(lo, n):
        ids, dists = g.query(pool[lo : lo + n], *args, engine=engine, **kw)
        if tamper is not None:
            ids, dists = tamper(ids, dists)
        return ids, dists
    return call


def run_cell(bench: dict, name: str, *, seed: int, seconds: float, trace: bool,
             roots=registry.ROOTS, device="cuda", t_start: float | None = None,
             tamper=None, log=sys.stderr):
    """One run of cell ``name``. Returns (the result line's dict, the
    numbers compared). ``tamper(ids, dists) -> (ids, dists)``, for tests
    only, alters each answer where the program returns it."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = registry.cell(bench, name)
    cfg = registry.config(cell["config"], roots)
    mix = registry.traffic(cell["traffic"], roots)
    metrics = registry.cell_metrics(bench, name, trace)
    readers = {m["name"]: registry.metric_reader(m["name"], roots) for m in metrics}

    base, pool = data.generate(cfg["data"], int(cfg["n_base"]), int(cfg["dim"]),
                               int(mix["pool"]), seed, device)
    from ggnn_torch.utils import graphs

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    g, build_s = build_program(cfg, base, device)
    call = query_fn(g, cfg, pool, tamper=tamper)
    for lo, n in cycle(mix):
        call(lo, n)
    _sync(device)
    captures = graphs.stats()["captures"]
    run = Run(cell, cfg, mix, build_s=build_s,
              phases=dict(g.last_build_stats["shards"][0]["phases"]))
    run.setup_s = time.perf_counter() - t_start

    answered = []
    sched = data.schedule(mix)
    w0 = time.perf_counter()
    while True:
        lo, n = next(sched)
        t_sub = time.perf_counter()
        ids, dists = call(lo, n)
        t_done = time.perf_counter()
        run.latencies.append(t_done - t_sub)
        answered.append((lo, n, ids, dists))
        run.queries += n
        if t_done - w0 >= seconds:
            break
    run.window_s = time.perf_counter() - w0
    window_captures = graphs.stats()["captures"] - captures

    if trace:
        run.trace = _traced(call, mix, device, graphs, answered)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    g.close()
    del g, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"# build phases (s): {json.dumps(run.phases)}", file=log)
    print(f"# window: {len(run.latencies)} calls, {run.queries} queries in "
          f"{run.window_s:.3f} s; walk graphs captured in it: {window_captures}",
          file=log, flush=True)

    gt = reference.exact_knn(base, pool, RECALL_K,
                             measure=cfg["measure"])[0].cpu().numpy()
    rows, ids, dists, canon, per_call = _answers(answered)
    in_window = len(run.latencies)
    run.recall = _recall(answered[:in_window], canon, per_call[:in_window],
                         gt, RECALL_K)
    recall = (_recall(answered, canon, per_call, gt, RECALL_K)
              if len(answered) > in_window else run.recall)
    checks = reference.judge(base, pool, rows, ids, dists, cfg["limits"],
                             recall=recall, measure=cfg["measure"])
    bad = checks["bad_ids"]["value"] + checks["dup_rows"]["value"]

    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else device.type),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = _power_limit()
    out = {"correct": reference.passed(checks), "attempted": run.queries,
           "failed": bad, "metrics": values, "device": dev}
    if run.trace is not None:
        lo, hi = run.trace.window
        dev["busy_s"] = tracing.busy_us(run.trace.events, lo, hi) / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        out["breakdown"] = tracing.breakdown(run.trace.events, lo, hi)
    out["checks"] = checks
    return out, checks


def _traced(call, mix, device, graphs, answered) -> tracing.Trace:
    """:data:`TRACE_CALLS` calls of the mix under ``torch.profiler`` after
    one warm-up call, each in a :data:`tracing.CALL_SPAN` range; their
    answers join ``answered`` for the judgement."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    plan = list(itertools.islice(data.schedule(mix), TRACE_CALLS + 1))
    with tempfile.TemporaryDirectory(prefix="annbench_trace_") as tmp:
        path = Path(tmp) / "trace.json"
        with profile(activities=activities, record_shapes=True,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                     ) as prof:
            lo, n = plan[0]
            answered.append((lo, n, *call(lo, n)))
            _sync(device)
            prof.step()
            reads = graphs.stats()["live_reads"]
            for lo, n in plan[1:]:
                with record_function(tracing.CALL_SPAN):
                    answered.append((lo, n, *call(lo, n)))
            _sync(device)
            reads = graphs.stats()["live_reads"] - reads
            prof.step()
        events = json.loads(path.read_text())["traceEvents"]
    return tracing.Trace(events, calls=TRACE_CALLS,
                         queries=sum(n for _, n in plan[1:]),
                         counters={"live_reads": reads})
