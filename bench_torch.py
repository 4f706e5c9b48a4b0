#!/usr/bin/env python
"""GGNN headline benchmark of the PyTorch port (``ggnn_torch``), on one GPU.

The counterpart of the JAX package's ``bench.py``, on the same data and the
same sweep: builds a GGNN search graph over the synthetic SIFT-like dataset
(clustered uint8-range vectors, D=128, 1,000,000 points resident on the
device by default), derives the fused index, computes brute-force ground
truth for 50,000 queries, sweeps (tau_query, pop budget, pops per step)
cheapest first for the fastest point with c@1 >= 0.9 and reports its query
throughput.

    python3 bench_torch.py                          # on the GPU
    GGNN_BENCH_DEVICE=cpu GGNN_BENCH_N=4096 GGNN_BENCH_NQ=500 \\
        python3 bench_torch.py                      # small, on the CPU

Prints ONE JSON line with ``bench.py``'s keys:
  {"metric": "qps_c1_90", "value": <QPS>, "unit": "queries/s",
   "vs_baseline": <QPS / 500000>, "detail": {..., "device": <device name>}}

Environment knobs (those of ``bench.py``, plus the device):
GGNN_BENCH_N (base size, default 1,000,000), GGNN_BENCH_NQ (queries,
50,000), GGNN_BENCH_K (graph degree, 48), GGNN_BENCH_GROUP (fused index
group, 1), GGNN_BENCH_VERBOSE (log level), GGNN_BENCH_CACHE=<dir> (store the
graph and ground truth there and reload them on a rerun, whose reported
build time is the one recorded at store time; empty: no cache; default
``.bench_graph_torch_1m`` or ``.bench_graph_torch_<n>`` beside this
script), GGNN_BENCH_WARM_BUILD=0 (report the first build instead of a
second one in the same process), GGNN_BENCH_CURVE=1 (run every sweep point),
GGNN_PROFILE_DIR=<dir> (a ``torch.profiler`` Chrome trace of the run,
written there as ``trace.json``), GGNN_BENCH_DEVICE (default ``cuda``;
without a CUDA device the run fails: the CPU is used only when asked for).

Any error, at any sweep point too, ends the run with a non-zero exit.
"""

import json
import os
import sys
import time

import numpy as np
import torch

from ggnn_torch import GGNN, Evaluator, set_log_level
from ggnn_torch.ops import adjacency, approx_topk, beam, gather_dist

BASELINE_QPS = 500_000.0

# Bump whenever the port's construction path changes materially: a cached
# graph's recorded build time is then stale, and a mismatch rebuilds. Kept
# apart from the JAX package's version: its caches never count as the
# port's (``CACHE_PACKAGE`` below).
# 1 = the port's bulk-sym, dense-seed quantized build; 2 = its merges seeded
# by the TPU's approximate top-k
BUILD_PATH_VERSION = 2
CACHE_PACKAGE = "ggnn_torch"
DATASET_SEED = 0

K_QUERY = 10
TAU_BUILD = 0.5
MAX_ITERATIONS = 400
# the fused engine's knobs (bench.py's ``qkw``)
QKW = {"engine": "fused", "num_seeds": 8,
       "rerank": max(16, K_QUERY + 6), "width": 32, "cap": 32}
# (tau, pop budget, pops per step), cheapest first (bench.py's ``sweep``)
SWEEP = [
    (0.64, 20, 4), (0.64, 24, 4),
    (0.64, 28, 4), (0.64, 30, 5),
    (0.64, 30, 3), (0.64, 32, 4), (0.64, 35, 5),
    (0.64, 40, 5), (0.64, 48, 8),
    (0.41, 64, 8), (0.51, 64, 8),
    (0.41, 100, 8), (0.51, 100, 8), (0.64, 100, 8),
    (0.41, 200, 8), (0.64, 200, 8),
    (0.8, 200, 8), (1.0, 400, 8), (1.3, 400, 8),
]


def make_dataset(n, nq, d=128, d_latent=24, seed=0):
    """SIFT-like synthetic vectors: uint8-range, low intrinsic dimension
    (bench.py's generator: the same arrays for the same arguments).

    A ``d_latent``-dim Gaussian latent through a random linear map gives one
    connected continuum with realistic ANN difficulty, as real descriptor
    sets are."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d_latent, d)).astype(np.float32) / np.sqrt(d_latent)

    def sample(m):
        z = rng.normal(size=(m, d_latent)).astype(np.float32)
        x = z @ w * 40.0 + 128.0 + rng.normal(0, 4, size=(m, d)).astype(np.float32)
        return np.clip(x, 0, 255).astype(np.float32)

    return sample(n), sample(nq)


def default_cache_dir(n):
    """The cache of an ``n``-point run beside this script."""
    name = ".bench_graph_torch_1m" if n == 1_000_000 else f".bench_graph_torch_{n}"
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), name)


def _fence(device):
    """Wait for the work queued on ``device`` (a CUDA device; the CPU's
    work is done when its calls return)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_config(g, evaluator, query_dev, nq, k_query, tau_query, iters, qkw,
                best, pops_per_iter=8, reps=5, points=None):
    """Warm and time one (tau, budget, P) sweep point; fold it into ``best``.

    Two warm-up calls, then ``reps`` ``query_async`` calls sent back to
    back with the results left on the device and one synchronise of the
    device after the last, all on the host clock: the reference's
    cudaEvent span around the query kernel with ``d_results`` left on the
    GPU (gpu_instance.cu:688-712). The ids are copied to the host after the
    clock stops. Appends the point to ``points`` when one is given."""
    qkw = dict(qkw, pops_per_iter=pops_per_iter)
    device = query_dev.device
    g.set_return_results_on_device(True)
    try:
        for _ in range(2):
            g.query(query_dev, k_query, tau_query, iters, **qkw)
            _fence(device)
        t0 = time.perf_counter()
        futs = [g.query_async(query_dev, k_query, tau_query, iters, **qkw)
                for _ in range(reps)]
        outs = [f.result() for f in futs]  # device tensors, no host copy
        _fence(device)
        elapsed = (time.perf_counter() - t0) / reps
        ids = outs[-1].ids.cpu().numpy()  # untimed, like the reference
    finally:
        g.set_return_results_on_device(False)
    ev = evaluator.evaluate_results(ids)
    qps = nq / elapsed
    print(f"# tau={tau_query} iters={iters} P={pops_per_iter}: c@1={ev.c1:.4f} "
          f"c@10={ev.cKQuery:.4f} qps={qps:,.0f}", file=sys.stderr, flush=True)
    if points is not None:
        points.append({"tau": tau_query, "iters": iters, "P": pops_per_iter,
                       "qps": qps, "c1": ev.c1, "c10": ev.cKQuery})
    if ev.c1 >= 0.90 and (best is None or qps > best["qps"]):
        best = {"tau": tau_query, "iters": iters, "P": pops_per_iter,
                "qps": qps, "c1": ev.c1, "c10": ev.cKQuery}
    return best


def _device_name(device):
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def _cached_meta(meta_path, meta_now):
    """The stored meta when it matches ``meta_now`` in every key (the same
    configuration, package and build path), else None: the cache is stale,
    or another package's."""
    if not meta_path or not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        cached = json.load(f)
    if any(cached.get(k) != v for k, v in meta_now.items()):
        return None
    return cached


def _peaks(device, stats, stage):
    """Record the device memory allocated and reserved at its peak during
    ``stage`` into ``stats`` and start the next stage's count (CUDA only)."""
    if stats is None or device.type != "cuda":
        return
    stats.setdefault("peak_memory", {})[stage] = {
        "allocated": torch.cuda.max_memory_allocated(device),
        "reserved": torch.cuda.max_memory_reserved(device)}
    torch.cuda.reset_peak_memory_stats(device)


def _build(g, base, k_build):
    """Build ``g``'s graph over ``base``; returns the seconds it took."""
    g.set_base(base)
    t0 = time.perf_counter()
    g.build(k_build=k_build, tau_build=TAU_BUILD, refinement_iterations=2)
    return time.perf_counter() - t0


def run(n, nq, k_build, group, device, cache, warm_build, curve, sweep=SWEEP,
        reps=5, stats=None):
    """Build (or load from ``cache``), index, ground truth and the sweep;
    returns the result dict that :func:`main` prints.

    ``stats``: a dict that receives what the run saw beside its result --
    whether the graph came from the cache, the build's phase seconds, the
    index, brute-force and sweep seconds, the index's device bytes per
    point, every sweep point, the adjacency, the dedup, the seeding's
    approximate top-k and the walks' gather + distance kernels' launches in
    the build and in the queries,
    the data with the ground truth, on CUDA the peak device memory of each
    stage, and the ``GGNN`` itself under ``"ggnn"``, left open for the
    caller to query further and close (without ``stats`` the run closes
    it)."""
    g = GGNN(device=device)  # no CUDA device: raises here
    device = g.device
    print(f"# device: {_device_name(device)}", file=sys.stderr)
    if stats is not None and device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0, dedup0 = adjacency.launches, beam.launches
    approx0, gather0 = approx_topk.launches, gather_dist.launches
    base, query = make_dataset(n, nq, seed=DATASET_SEED)

    meta_path = os.path.join(cache, "bench_meta.json") if cache else None
    meta_now = {"n": n, "k_build": k_build, "tau_build": TAU_BUILD,
                "dataset_seed": DATASET_SEED, "build_version": BUILD_PATH_VERSION,
                "package": CACHE_PACKAGE}
    cached = _cached_meta(meta_path, meta_now)
    t0 = time.perf_counter()
    if cached is not None:
        g.set_base(base)
        g.set_working_directory(cache)
        g.load(k_build)
        build_s, build_cold_s = cached["build_s"], cached.get("build_cold_s")
        phases = cached.get("phases")
        print(f"# build: {build_s:.2f} s (cached from {cache})", file=sys.stderr)
        _peaks(device, stats, "load")
    else:
        build_cold_s = _build(g, base, k_build)
        print(f"# build (cold): {build_cold_s:.2f} s "
              f"({build_cold_s * 1e6 / n:.2f} us/point)", file=sys.stderr)
        build_s = build_cold_s
        if warm_build:
            # the same build again in this process: the kernel is loaded and
            # the allocator warm, as the reference's compile-free C++ build
            g.close()
            g = GGNN(device=device)
            build_s = _build(g, base, k_build)
            print(f"# build (warm): {build_s:.2f} s "
                  f"({build_s * 1e6 / n:.2f} us/point)", file=sys.stderr)
        phases = g.last_build_stats["shards"][0]["phases"]
        _peaks(device, stats, "build")
    launches_build = adjacency.launches - launches0
    dedup_build = beam.launches - dedup0
    approx_build = approx_topk.launches - approx0
    gather_build = gather_dist.launches - gather0
    load_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    g.build_fused_index(group=group)
    _fence(device)
    index_s = time.perf_counter() - t0
    _peaks(device, stats, "index")
    if cache and cached is None:
        os.makedirs(cache, exist_ok=True)
        g.set_working_directory(cache)
        g.store()
        with open(meta_path, "w") as f:
            json.dump(dict(meta_now, build_s=build_s, build_cold_s=build_cold_s,
                           phases=phases), f)

    # the ground truth depends on the query count: one file per nq
    gt_path = os.path.join(cache, f"gt_{nq}.npy") if cache else None
    t0 = time.perf_counter()
    gt_dists = None
    if gt_path and cached is not None and os.path.exists(gt_path):
        gt_ids = np.load(gt_path)
        print("# brute force: cached", file=sys.stderr)
    else:
        gt_ids, gt_dists = g.bf_query(query, k_gt=max(100, K_QUERY))
        print(f"# brute force: {time.perf_counter() - t0:.2f} s", file=sys.stderr)
        if gt_path:
            np.save(gt_path, gt_ids)
    bf_s = time.perf_counter() - t0
    _peaks(device, stats, "ground_truth")
    evaluator = Evaluator(base, query, gt_ids, k_query=K_QUERY)

    # the queries go to the device once, outside the timed region
    query_dev = torch.from_numpy(query).to(device)
    launches_swept, dedup_swept = adjacency.launches, beam.launches
    approx_swept, gather_swept = approx_topk.launches, gather_dist.launches
    points = []
    best = None
    t0 = time.perf_counter()
    for tau_query, iters, pops in sweep:
        iters = min(iters, MAX_ITERATIONS)
        best = _run_config(g, evaluator, query_dev, nq, K_QUERY, tau_query,
                           iters, QKW, best, pops_per_iter=pops, reps=reps,
                           points=points)
        # cheapest first: once a point qualifies, one with a much larger pop
        # budget can only be slower; +8 keeps near-budget neighbours in play
        if best is not None and iters > best["iters"] + 8 and not curve:
            break
    sweep_s = time.perf_counter() - t0
    _peaks(device, stats, "sweep")
    if best is None:
        best = {"tau": None, "iters": None, "qps": 0.0, "c1": 0.0, "c10": 0.0}

    # this run's best point beside its cache, for runs at the other size
    if meta_path and os.path.exists(meta_path) and best.get("tau") is not None:
        with open(meta_path) as f:
            meta_disk = json.load(f)
        meta_disk["last_result"] = {
            "qps": round(best["qps"], 1), "c1": round(best["c1"], 4),
            "tau": best["tau"], "iters": best["iters"], "P": best["P"]}
        with open(meta_path, "w") as f:
            json.dump(meta_disk, f)
    secondaries = {}
    for other_n in (262_144, 1_000_000):
        if other_n == n:
            continue
        other = _cached_meta(os.path.join(default_cache_dir(other_n),
                                          "bench_meta.json"),
                             {"build_version": BUILD_PATH_VERSION,
                              "package": CACHE_PACKAGE})
        if other is not None and other.get("last_result"):
            secondaries[f"n{other_n}"] = other["last_result"]

    if stats is not None:
        shard = g._shards[0]
        index_bytes = sum(t.numel() * t.element_size()
                          for t in shard.ensure_fused_index())
        stats.update({
            "cached": cached is not None, "build_phases": phases,
            "build_or_load_s": load_s, "index_s": index_s, "bf_s": bf_s,
            "sweep_s": sweep_s, "points": points,
            "index_bytes_per_point": index_bytes / n,
            # the base and its norms, which the exact re-rank reads
            "base_bytes_per_point": (shard.base_dev.element_size()
                                     * base.shape[1] + 4),
            "launches_build": launches_build,
            "launches_queries": adjacency.launches - launches_swept,
            "dedup_launches_build": dedup_build,
            "dedup_launches_queries": beam.launches - dedup_swept,
            "approx_launches_build": approx_build,
            "approx_launches_queries": approx_topk.launches - approx_swept,
            "gather_launches_build": gather_build,
            "gather_launches_queries": gather_dist.launches - gather_swept,
            "base": base, "query": query, "gt_ids": gt_ids, "gt_dists": gt_dists,
            "ggnn": g,
        })
    else:
        g.close()

    return {
        "metric": "qps_c1_90",
        "value": round(best["qps"], 1),
        "unit": "queries/s",
        "vs_baseline": round(best["qps"] / BASELINE_QPS, 4),
        "detail": {
            "timing": "host clock around pipelined query_async calls, results "
                      "left on the device, one torch.cuda.synchronize after the "
                      "last (reference cudaEvent parity, gpu_instance.cu:688-712)",
            "N": n,
            "NQ": nq,
            "k_build": k_build,
            "tau_build": TAU_BUILD,
            "tau_query": best["tau"],
            "max_iterations": best.get("iters") or MAX_ITERATIONS,
            "pops_per_iter": best.get("P"),
            "group": group,
            "c1": round(best["c1"], 4),
            "c10": round(best["c10"], 4),
            "build_s": round(build_s, 2),
            "build_us_per_point": round(build_s * 1e6 / n, 2),
            # the first build in a fresh process (kernel build included)
            "build_cold_s": round(build_cold_s, 2) if build_cold_s else None,
            # earlier recorded operating points at OTHER dataset sizes
            # (same package and build path version), for context only
            **({"secondary": secondaries} if secondaries else {}),
            "device": _device_name(device),
        },
    }


def main():
    n = int(os.environ.get("GGNN_BENCH_N", 1_000_000))
    nq = int(os.environ.get("GGNN_BENCH_NQ", 50_000))
    k_build = int(os.environ.get("GGNN_BENCH_K", 48))
    group = int(os.environ.get("GGNN_BENCH_GROUP", 1))
    device = os.environ.get("GGNN_BENCH_DEVICE", "cuda")
    set_log_level(int(os.environ.get("GGNN_BENCH_VERBOSE", 0)))
    cache = os.environ.get("GGNN_BENCH_CACHE", default_cache_dir(n)) or None
    warm_build = os.environ.get("GGNN_BENCH_WARM_BUILD", "1") != "0"
    curve = bool(os.environ.get("GGNN_BENCH_CURVE"))
    profile_dir = os.environ.get("GGNN_PROFILE_DIR")
    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    result = run(n, nq, k_build, group, device, cache, warm_build, curve)
    if prof is not None:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
