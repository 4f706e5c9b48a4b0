#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ggnn_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: print the ``nvidia-smi`` name and power-limit line; a CUDA device
   is required (there is no CPU fallback).
2. Kernel build: compile ``ggnn_torch/csrc/adjacency_dot.cu`` from this
   checkout and print the seconds it took.
3. Kernel against plain: ``adjacency_dot`` vs ``adjacency_dot_plain`` on the
   card at the main path's shapes (B=8192 rows, P=8 anchors, 48 code rows
   of D=128 bytes, ~10% empty anchors; and the int4 layout with 24 rows),
   live lanes compared at rtol 1e-5 / atol 1e-2 (f32 summation order);
   both timed with CUDA events after a warm-up.
4. Main path: ``GGNN(device="cuda")`` builds a 262,144-point graph
   (k_build=48, tau_build=0.5, 2 refinements) over the benchmark's
   synthetic SIFT-like data, derives the fused index, computes brute-force
   ground truth for 10,000 queries and sweeps fused-query operating points
   cheapest first until c@1 >= 0.90. QPS is timed with CUDA events around
   the queries alone, queries already on the card and results left there.
   The kernel's launch counter must rise during the build and again during
   the queries.
5. Row engine on the same graph and queries (``engine="row"``,
   ``pops_per_iter=8``, ``fetch_cap_fraction=0.75``): the (tau, pop budget)
   sweep ``ROW_SWEEP`` cheapest first until c@1 >= 0.90, timed like phase 4
   (3 timed calls after 1 warm-up); the returned
   distances must be the exact ones. Prints the device bytes of the row
   layout (graph + f32 base) beside the fused index's. The kernel must not
   launch: the row walk gathers f32 rows.
6. The exact f32-fetch build (``quantized_fetch=False``, the schedule every
   base above 1,048,576 points takes at k=48, D=128) of the same 262,144
   points, then the row sweep on it until c@1 >= 0.90. The kernel must not
   launch during the build.
7. The reference's own build shape (``dense_seed_merge=False``,
   ``sym_mode="walk"``: segment-seeded hierarchic descent, every unconnected
   pair walked) at 65,536 points and 10,000 queries -- cut from 262,144 to
   hold the run's time, the walking sym pass being the costly part -- then
   the row sweep until c@1 >= 0.90. The kernel must launch in the build (the
   descent's quantized legs).
8. One JSON line with the kernel's numbers, then the last line
   ``{"ok": true, "device": {...}}``.

Every phase prints its seconds. Kernel launch counts are set to 0 just
before each path runs and read just after it.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ggnn_torch import GGNN, Evaluator
from ggnn_torch.ops import adjacency

N, NQ, D = 262_144, 10_000, 128
K_BUILD, TAU_BUILD, K_QUERY = 48, 0.5, 10
# fused-query knobs and the (tau, pop budget, pops per step) sweep of the
# JAX package's benchmark (bench.py), cheapest first
QKW = {"engine": "fused", "num_seeds": 8, "rerank": 16, "width": 32, "cap": 32}
SWEEP = [
    (0.64, 20, 4), (0.64, 24, 4), (0.64, 28, 4), (0.64, 32, 4),
    (0.64, 40, 5), (0.64, 48, 8), (0.51, 64, 8), (0.64, 100, 8),
    (0.64, 200, 8),
]
TARGET_C1 = 0.90
# row-engine (tau, pop budget) points, cheapest first, and its knobs; the
# four cheapest come before the JAX package's row points, whose first
# already lies far above c@1 0.90 on this data
ROW_SWEEP = [(0.4, 24), (0.45, 32), (0.5, 48), (0.5, 64),
             (0.5, 100), (0.64, 200), (0.7, 200), (0.64, 400), (1.0, 400)]
ROW_KW = {"engine": "row", "pops_per_iter": 8, "fetch_cap_fraction": 0.75}
N_DESCENT = 65_536


def make_dataset(n, nq, d=128, d_latent=24, seed=0):
    """SIFT-like synthetic vectors: uint8-range, low intrinsic dimension
    (the generator of the JAX package's bench.py)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d_latent, d)).astype(np.float32) / np.sqrt(d_latent)

    def sample(m):
        z = rng.normal(size=(m, d_latent)).astype(np.float32)
        x = z @ w * 40.0 + 128.0 + rng.normal(0, 4, size=(m, d)).astype(np.float32)
        return np.clip(x, 0, 255).astype(np.float32)

    return sample(n), sample(nq)


def time_ms(fn, device, reps=10, warmup=2):
    """Mean milliseconds per call: CUDA events around ``reps`` calls on a
    CUDA device (host clock after a synchronise on the CPU, for rehearsals
    at a tiny size)."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def check_kernel(device, nibbles, B=8192, P=8, Nb=N):
    """Kernel vs its plain version at the main path's shapes."""
    CR = 24 if nibbles else 48
    gen = torch.Generator(device=device).manual_seed(1 + nibbles)
    # query rows at the main path's magnitudes (uint8-range data, scale ~1)
    qs = torch.rand((B, D), generator=gen, device=device) * 255.0
    anchors = torch.randint(0, Nb, (B, P), generator=gen, device=device,
                            dtype=torch.int32)
    empty = torch.rand((B, P), generator=gen, device=device) < 0.1
    anchors = torch.where(empty, -1, anchors)
    blocks = torch.randint(0, 256, (Nb, CR, D), generator=gen, device=device,
                           dtype=torch.uint8)
    out = adjacency.adjacency_dot(qs, anchors, blocks, nibbles=nibbles)
    torch.cuda.synchronize(device)
    ref = adjacency.adjacency_dot_plain(qs, anchors, blocks, nibbles=nibbles)
    live = (anchors >= 0)[:, :, None].expand_as(ref)
    err = float((out - ref).abs()[live].max())
    if not torch.allclose(out[live], ref[live], rtol=1e-5, atol=1e-2):
        raise AssertionError(f"adjacency_dot (nibbles={nibbles}) disagrees with "
                             f"its plain version: max abs err {err}")
    ms, _ = time_ms(lambda: adjacency.adjacency_dot(qs, anchors, blocks,
                                                    nibbles=nibbles), device)
    plain_ms, _ = time_ms(lambda: adjacency.adjacency_dot_plain(
        qs, anchors, blocks, nibbles=nibbles), device)
    gbs = int(live[:, :, 0].sum()) * CR * D / (ms * 1e-3) / 1e9
    print(f"adjacency_dot nibbles={nibbles} B={B} P={P} CR={CR} D={D}: "
          f"max abs err {err:.6g} | kernel {ms:.4f} ms ({gbs:.0f} GB/s of "
          f"live blocks) | plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _launched(count, what, device):
    """The kernel must have launched (on the card; the CPU rehearsal runs
    the plain version, which counts nothing)."""
    if device.type == "cuda" and count <= 0:
        raise AssertionError(f"{what} never launched the adjacency kernel")


def _not_launched(count, what):
    if count != 0:
        raise AssertionError(f"{what} launched the adjacency kernel {count} "
                             "times; its path runs no kernel")


def _check_exact(ids, dists, base, query):
    """The first query's returned distances are the exact ones."""
    row = ids[0][ids[0] >= 0]
    exact = np.sum((base[row] - query[0]) ** 2, axis=-1)
    if not np.allclose(dists[0][: len(row)], exact, rtol=1e-4, atol=1e-2):
        raise AssertionError("query distances are not the exact ones")


def sweep(g, query_dev, base, query, evaluator, points, kw, device, label,
          reps=5, warmup=2):
    """Query operating points cheapest first until c@1 >= 0.90; QPS from
    CUDA events around the query calls alone (results left on the card).
    Returns the first point that reached the target."""
    nq = query.shape[0]
    g.set_return_results_on_device(True)
    best = None
    for point in points:
        tau, iters = point[:2]
        call_kw = dict(kw) if len(point) == 2 else dict(kw, pops_per_iter=point[2])
        ms, res = time_ms(
            lambda: g.query(query_dev, K_QUERY, tau, iters, **call_kw), device,
            reps=reps, warmup=warmup,
        )
        ids = res.ids.cpu().numpy()
        dists = res.dists.cpu().numpy()
        if ids.shape != (nq, K_QUERY) or not np.all(np.isfinite(dists)):
            raise AssertionError(f"{label} query returned malformed results")
        ev = evaluator.evaluate_results(ids)
        qps = nq / (ms * 1e-3)
        print(f"{label} query tau={tau} iters={iters} "
              f"P={call_kw['pops_per_iter']}: c@1={ev.c1:.4f} "
              f"c@10={ev.cKQuery:.4f} qps={qps:.1f} ({ms:.3f} ms / {nq} "
              "queries)", flush=True)
        if ev.c1 >= TARGET_C1:
            best = {"tau": tau, "iters": iters, "P": call_kw["pops_per_iter"],
                    "qps": qps, "c1": ev.c1, "c10": ev.cKQuery}
            _check_exact(ids, dists, base, query)
            break
    g.set_return_results_on_device(False)
    if best is None:
        raise AssertionError(f"{label}: no sweep point reached c@1 >= {TARGET_C1}")
    return best


def build(g, device, label, **kw):
    """One build; prints its seconds by phase kind and by phase."""
    t0 = time.perf_counter()
    g.build(k_build=K_BUILD, tau_build=TAU_BUILD, refinement_iterations=2, **kw)
    build_s = time.perf_counter() - t0
    n = g._base.shape[0]
    phases = g.last_build_stats["shards"][0]["phases"]
    kinds = {}
    for name, sec in phases.items():
        kinds[name.split("[")[0]] = kinds.get(name.split("[")[0], 0.0) + sec
    print(f"{label} build: {build_s:.2f} s for N={n} ({build_s * 1e6 / n:.2f} "
          f"us/point) | by kind "
          f"{json.dumps({k: round(v, 3) for k, v in kinds.items()})}", flush=True)
    print(f"{label} build phases (s): "
          + json.dumps({k: round(v, 3) for k, v in phases.items()}), flush=True)
    return build_s


def ground_truth(g, base, query):
    t0 = time.perf_counter()
    gt_ids, gt_d = g.bf_query(query, k_gt=100)
    bf_s = time.perf_counter() - t0
    if gt_ids.shape != (query.shape[0], 100) or not np.all(np.isfinite(gt_d)):
        raise AssertionError("brute force returned malformed ground truth")
    print(f"brute force ({query.shape[0]} x {base.shape[0]}, k=100): "
          f"{bf_s:.2f} s", flush=True)
    return Evaluator(base, query, gt_ids, k_query=K_QUERY), bf_s


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def main_path(device, n=N, nq=NQ):
    """The fused path: build, index, ground truth and the fused sweep.
    Returns a summary with the kernel's launches in the build and in the
    whole path, and what the row phase reuses (graph, data, evaluator)."""
    base, query = make_dataset(n, nq, d=D, seed=0)
    g = GGNN(device=device)
    g.set_base(base)
    adjacency.launches = 0
    build_s = build(g, device, "fused-path")
    launches_build = adjacency.launches
    t0 = time.perf_counter()
    g.build_fused_index(group=1)
    print(f"fused index: {time.perf_counter() - t0:.2f} s", flush=True)
    evaluator, bf_s = ground_truth(g, base, query)
    query_dev = torch.from_numpy(query).to(device)
    best = sweep(g, query_dev, base, query, evaluator, SWEEP, QKW, device,
                 "fused")
    launches_total = adjacency.launches
    _launched(launches_build, "the build", device)
    _launched(launches_total - launches_build, "the fused queries", device)
    print(f"operating point: {json.dumps(best)} | kernel launches: build "
          f"{launches_build}, queries {launches_total - launches_build}",
          flush=True)
    summary = {"launches": launches_total, "build_s": build_s, "bf_s": bf_s,
               **best}
    return summary, {"g": g, "base": base, "query": query,
                     "query_dev": query_dev, "evaluator": evaluator}


def row_path(device, ctx):
    """The row engine on the fused path's graph and queries."""
    g = ctx["g"]
    graph = g.get_graph()
    row_bytes = _nbytes([*graph.neighbors, *graph.selection, *graph.translation,
                         g._base])
    fused_bytes = _nbytes(g._index)
    n = g._base.shape[0]
    print(f"device bytes: row layout (graph + f32 base) {row_bytes} "
          f"({row_bytes / n:.1f} B/point) | fused index {fused_bytes} "
          f"({fused_bytes / n:.1f} B/point; the fused engine also keeps the "
          "base for its re-rank)", flush=True)
    adjacency.launches = 0
    best = sweep(g, ctx["query_dev"], ctx["base"], ctx["query"],
                 ctx["evaluator"], ROW_SWEEP, ROW_KW, device, "row",
                 reps=3, warmup=1)
    _not_launched(adjacency.launches, "the row queries")
    print(f"row operating point: {json.dumps(best)}", flush=True)
    return {**best, "row_bytes": row_bytes, "fused_bytes": fused_bytes}


def other_build(device, label, n, nq, start, **build_kw):
    """Build ``n`` points with ``build_kw``, then the row sweep from sweep
    point ``start`` on. Returns (kernel launches in the build, summary)."""
    base, query = make_dataset(n, nq, d=D, seed=0)
    g = GGNN(device=device)
    g.set_base(base)
    adjacency.launches = 0
    build_s = build(g, device, label, **build_kw)
    launches = adjacency.launches
    evaluator, _ = ground_truth(g, base, query)
    query_dev = torch.from_numpy(query).to(device)
    best = sweep(g, query_dev, base, query, evaluator, ROW_SWEEP[start:],
                 ROW_KW, device, f"{label} row", reps=3, warmup=1)
    print(f"{label}: {json.dumps(best)} | kernel launches in the build "
          f"{launches}", flush=True)
    return launches, {"build_s": build_s, **best}


def _phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    return time.perf_counter()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = _phase("device", t0)

    build_s = adjacency.build_kernel()
    print(f"kernel build: {build_s:.2f} s", flush=True)
    t0 = _phase("kernel build", t0)
    u8 = check_kernel(device, nibbles=False)
    check_kernel(device, nibbles=True)
    torch.cuda.empty_cache()
    t0 = _phase("kernel vs plain", t0)

    summary, ctx = main_path(device)
    t0 = _phase("fused path (build, index, ground truth, sweep)", t0)
    row = row_path(device, ctx)
    del ctx
    torch.cuda.empty_cache()
    t0 = _phase("row engine sweep", t0)
    start = ROW_SWEEP.index((row["tau"], row["iters"]))
    launches, f32 = other_build(device, "f32-fetch", N, NQ, start,
                                quantized_fetch=False)
    _not_launched(launches, "the f32-fetch build")
    torch.cuda.empty_cache()
    t0 = _phase("f32-fetch build + row sweep", t0)
    launches, descent = other_build(device, "descent+walk", N_DESCENT, NQ, 0,
                                    dense_seed_merge=False, sym_mode="walk")
    _launched(launches, "the descent build's quantized legs", device)
    t0 = _phase("descent build + row sweep", t0)
    print("summary: " + json.dumps({
        "fused": {k: summary[k] for k in ("tau", "iters", "P", "qps", "c1",
                                          "c10", "build_s")},
        "row": row, "f32_fetch_build": f32, "descent_walk_build": descent,
    }), flush=True)

    kernels = [{
        "name": "adjacency_dot",
        "route": "cuda",
        "source": "ggnn_torch/csrc/adjacency_dot.cu",
        "replaces": "ggnn_tpu/ops/adjacency_pallas.py:156",
        "launches": summary["launches"],
        **u8,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
