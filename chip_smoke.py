#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ggnn_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: print the ``nvidia-smi`` name and power-limit line; a CUDA device
   is required (there is no CPU fallback).
2. Kernel build: compile ``ggnn_torch/csrc/adjacency_dot.cu`` from this
   checkout and print the seconds it took, then each kernel's registers,
   shared and local (spill) bytes (``cuobjdump -res-usage``) and the count
   of ``I2F*`` instructions in its SASS (``cuobjdump -sass``; 0 by design),
   or "not available" where the toolkit has no ``cuobjdump``.
3. Kernel against plain: ``adjacency_dot`` vs ``adjacency_dot_plain`` on the
   card at the paths' shapes (B=8192 rows, P=8 anchors, D=128 bytes per
   code row, ~10% empty anchors: 48 rows per block for group 1, 24 for
   int4, 96 over half as many blocks for group 2), live lanes compared at
   rtol 1e-5 / atol 1e-2 (f32 summation order); both timed with CUDA events
   after a warm-up. Phases 4 and 6 repeat the check on the real anchors of
   a fused query's third walk step for each layout.
4. Main path: ``GGNN(device="cuda")`` builds a 262,144-point graph
   (k_build=48, tau_build=0.5, 2 refinements) over the benchmark's
   synthetic SIFT-like data, derives the fused index, computes brute-force
   ground truth for 10,000 queries and sweeps fused-query operating points
   cheapest first until c@1 >= 0.90. QPS is timed with CUDA events around
   the queries alone, queries already on the card and results left there.
   The kernel's launch counter must rise during the build and again during
   the queries. Then one call at the operating point runs under
   ``torch.profiler``: its host-clock ms, the device's busy ms and the
   adjacency kernel's launches and ms in it.
5. Row engine on the same graph and queries (``engine="row"``,
   ``pops_per_iter=8``, ``fetch_cap_fraction=0.75``): the (tau, pop budget)
   sweep ``ROW_SWEEP`` cheapest first until c@1 >= 0.90, timed like phase 4
   (3 timed calls after 1 warm-up); the returned
   distances must be the exact ones. Prints the device bytes of the row
   layout (graph + f32 base) beside the fused index's. The kernel must not
   launch: the row walk gathers f32 rows.
6. Layouts on the fused path's graph: ``build_fused_index(group=2)`` and
   ``build_fused_index(bits=4)``, each followed by the fused sweep until
   c@1 >= 0.90; prints each layout's device bytes per point, index seconds
   and kernel launches. The kernel must launch in both, in ``nibbles`` mode
   (and only so) for int4.
7. The exact f32-fetch build (``quantized_fetch=False``, the schedule every
   base above 1,048,576 points takes at k=48, D=128) of the same 262,144
   points, then the row sweep on it until c@1 >= 0.90. The kernel must not
   launch during the build.
8. The reference's own build shape (``dense_seed_merge=False``,
   ``sym_mode="walk"``: segment-seeded hierarchic descent, every unconnected
   pair walked) at 65,536 points and 10,000 queries -- cut from 262,144 to
   hold the run's time, the walking sym pass being the costly part -- then
   the row sweep until c@1 >= 0.90. The kernel must launch in the build (the
   descent's quantized legs).
9. Shards out of core: 1,048,576 points (the JAX benchmark's 1M headline
   scale) as 4 shards of 262,144 on the one card, with at most 2 shards on
   the device (``set_max_device_shards(2)``) and a ``set_cpu_memory_limit``
   that holds one shard's host cache -- user settings that make the
   rotation reach the disk tier, since 80 GB would hold all four. Build,
   fused index (group 1, bits 8), brute force (10,000 x 1,048,576, k=100)
   and the fused sweep until c@1 >= 0.90 (CUDA events around the query
   calls, rotation included; 3 timed calls after 1 warm-up). Prints the
   evictions, spills, read-backs and stage-ins with their seconds, the build
   seconds per shard and the kernel launches. At the operating point the
   cap is raised to 4: the ids must equal the rotated run's exactly; then
   ``store()``, and a fresh ``GGNN`` through ``load(48)`` and
   ``build_fused_index()`` must reuse all 4 sidecars and return the same
   ids again.
10. The benchmark CLI: a 65,536-point base and 1,000 queries written as
   fvecs to a temporary directory, then ``python -m ggnn_torch.benchmark
   --shard_size 32768 --fused_group 2 --graph_dir <tmp>`` twice: the first
   run builds and stores, the second loads and reuses the sidecars; both
   must exit 0 and print their c@1 lines.
11. One JSON line with the kernel's numbers (its bound: the bytes it must
   move -- each block a live anchor names read once, the query rows and
   anchors read once, each live output lane written once -- at the H100's
   3.35 TB/s, against 2 flops per code at 67 TFLOP/s f32; the share of it
   reached; the int4, group-2 and real-anchor numbers; launches per path;
   the resources and the I2F count of phase 2),
   then the last line ``{"ok": true, "device": {...}}``.

Every phase prints its seconds. Kernel launch counts are set to 0 just
before each path runs and read just after it.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ggnn_torch import GGNN, Evaluator, GraphConfig, store_fvecs
from ggnn_torch.ops import adjacency
from ggnn_torch.query import fused as fused_mod

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
N_SHARDED, N_SHARD, MAX_DEVICE_SHARDS = 1_048_576, 262_144, 2
N_CLI, NQ_CLI, CLI_SHARD = 65_536, 1_000, 32_768
# the H100's published peaks (SXM, 700 W): HBM bytes/s and f32 FLOP/s
HBM_BYTES_S, F32_FLOP_S = 3.35e12, 67e12


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


def synthetic_inputs(device, nibbles, CR, B=8192, P=8, Nb=N):
    """Kernel inputs at one of the paths' shapes: ``CR`` code rows per block
    (48 for group 1, 96 for group 2, 24 for int4 at k=48) over ``Nb``
    blocks, ~10% empty anchors."""
    gen = torch.Generator(device=device).manual_seed(1 + nibbles)
    # query rows at the main path's magnitudes (uint8-range data, scale ~1)
    qs = torch.rand((B, D), generator=gen, device=device) * 255.0
    anchors = torch.randint(0, Nb, (B, P), generator=gen, device=device,
                            dtype=torch.int32)
    empty = torch.rand((B, P), generator=gen, device=device) < 0.1
    anchors = torch.where(empty, -1, anchors)
    blocks = torch.randint(0, 256, (Nb, CR, D), generator=gen, device=device,
                           dtype=torch.uint8)
    return qs, anchors, blocks


def check_kernel(device, nibbles, CR, B=8192, P=8, Nb=N):
    """Kernel vs its plain version on :func:`synthetic_inputs`."""
    qs, anchors, blocks = synthetic_inputs(device, nibbles, CR, B=B, P=P, Nb=Nb)
    return measure_kernel(device, qs, anchors, blocks, nibbles, "synthetic")


def bound(anchors, blocks, nibbles):
    """The least time the card could take for one kernel call: each block
    that a live anchor names read once, the query rows and anchors read
    once, each live output lane written once; 2 flops per code. Returns
    (bytes, flops, bound ms, "bytes" or "operations")."""
    B, P = anchors.shape
    _, CR, Dq = blocks.shape
    K = 2 * CR if nibbles else CR
    live = anchors >= 0
    n_live = int(live.sum())
    n_blocks = int(torch.unique(anchors[live]).numel())
    nbytes = n_blocks * CR * Dq + B * Dq * 4 + B * P * 4 + n_live * K * 4
    flops = 2 * n_live * K * Dq
    bytes_ms, ops_ms = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOP_S * 1e3
    return nbytes, flops, max(bytes_ms, ops_ms), (
        "bytes" if bytes_ms >= ops_ms else "operations")


def measure_kernel(device, qs, anchors, blocks, nibbles, label):
    """The kernel against its plain version on these inputs (live lanes at
    rtol 1e-5 / atol 1e-2: f32 summation order), both timed, and the least
    time the card could take for the call."""
    out = adjacency.adjacency_dot(qs, anchors, blocks, nibbles=nibbles)
    _sync(device)
    ref = adjacency.adjacency_dot_plain(qs, anchors, blocks, nibbles=nibbles)
    live = (anchors >= 0)[:, :, None].expand_as(ref)
    err = float((out - ref).abs()[live].max())
    if not torch.allclose(out[live], ref[live], rtol=1e-5, atol=1e-2):
        raise AssertionError(f"adjacency_dot (nibbles={nibbles}, {label}) "
                             f"disagrees with its plain version: max abs err {err}")
    ms, _ = time_ms(lambda: adjacency.adjacency_dot(qs, anchors, blocks,
                                                    nibbles=nibbles), device)
    plain_ms, _ = time_ms(lambda: adjacency.adjacency_dot_plain(
        qs, anchors, blocks, nibbles=nibbles), device)
    nbytes, flops, bound_ms, bound_by = bound(anchors, blocks, nibbles)
    B, P = anchors.shape
    _, CR, Dq = blocks.shape
    n_live = int(live[:, :, 0].sum())
    n_blocks = int(torch.unique(anchors[anchors >= 0]).numel())
    ops_ms = flops / F32_FLOP_S * 1e3
    gbs = n_live * CR * Dq / (ms * 1e-3) / 1e9
    print(f"adjacency_dot {label} nibbles={nibbles} B={B} P={P} CR={CR} "
          f"blocks={blocks.shape[0]} D={Dq}: live anchors {n_live}, distinct "
          f"blocks {n_blocks} | max abs err {err:.6g} | kernel {ms:.4f} ms "
          f"({gbs:.0f} GB/s of live blocks) | plain {plain_ms:.4f} ms | bound "
          f"{bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s; {flops} flop at 67 "
          f"TFLOP/s: {ops_ms:.4f} ms) | share of bound {bound_ms / ms:.3f}",
          flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "bytes": nbytes}


def kernel_on_real_anchors(device, g, query_dev, point, label):
    """The kernel measured on the inputs of the third launch (the third walk
    step of the first query tile) of one fused query call at ``point`` (tau,
    pop budget, P): real anchors on the shard's real index, past the first
    steps, whose anchors are the few shared seeds. Its launches are not the
    path's: call this after the path's counts are read."""
    calls = []
    launch = fused_mod.adjacency_dot

    def record(qs, anchors, blocks, *, nibbles=False):
        if len(calls) < 3:
            calls.append((qs.clone(), anchors.clone(), blocks, nibbles))
        return launch(qs, anchors, blocks, nibbles=nibbles)

    fused_mod.adjacency_dot = record
    try:
        g.query(query_dev, K_QUERY, point["tau"], point["iters"],
                **dict(QKW, pops_per_iter=point["P"]))
    finally:
        fused_mod.adjacency_dot = launch
    qs, anchors, blocks, nibbles = calls[-1]
    return measure_kernel(device, qs, anchors, blocks, nibbles,
                          f"real anchors ({label})")


def profile_call(device, fn, label):
    """One call of ``fn`` (after one warm-up) under ``torch.profiler``: its
    host-clock ms under the profiler, the ms in which the card ran a kernel
    or a copy (the union of their spans in the trace), and the adjacency
    kernel's launches and device ms -- what tells a slower call's host from
    its device. None on the CPU rehearsal, which has no device trace."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(prefix="ggnn_smoke_trace_") as tmp:
        prof.export_chrome_trace(str(Path(tmp) / "trace.json"))
        events = json.loads((Path(tmp) / "trace.json").read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    adj = [e["dur"] for e in kernels if e["name"].startswith("adjacency_dot")]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
           "busy_share": busy_us / 1e3 / wall_ms, "kernels": len(kernels),
           "adjacency_launches": len(adj), "adjacency_ms": sum(adj) / 1e3}
    print(f"profile of one {label} call: {wall_ms:.3f} ms on the host clock "
          f"under the profiler | device busy {out['device_busy_ms']:.3f} ms "
          f"({out['busy_share']:.3f}) in {len(kernels)} kernels | adjacency "
          f"kernel {len(adj)} launches, {out['adjacency_ms']:.3f} ms", flush=True)
    return out


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
    real = kernel_on_real_anchors(device, g, query_dev, best, "group 1")
    profile = profile_call(device, lambda: g.query(
        query_dev, K_QUERY, best["tau"], best["iters"],
        **dict(QKW, pops_per_iter=best["P"])), "fused query")
    summary = {"launches": launches_total, "build_s": build_s, "bf_s": bf_s,
               "real": real, "profile": profile, **best}
    return summary, {"g": g, "base": base, "query": query,
                     "query_dev": query_dev, "evaluator": evaluator}


def row_path(device, ctx):
    """The row engine on the fused path's graph and queries."""
    g = ctx["g"]
    graph = g.get_graph()
    shard = g._shards[0]
    row_bytes = _nbytes([*graph.neighbors, *graph.selection, *graph.translation,
                         shard.base_dev])
    fused_bytes = _nbytes(shard.fused_index)
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


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def layouts_path(device, ctx):
    """The grouped and int4 fused layouts on the fused path's graph, each
    swept until c@1 >= 0.90. Returns each layout's operating point, index
    seconds, device bytes per point and kernel launches."""
    g = ctx["g"]
    n = g._base.shape[0]
    out = {}
    for label, kw in (("group2", {"group": 2}), ("int4", {"bits": 4})):
        t0 = time.perf_counter()
        g.build_fused_index(**kw)
        _sync(device)
        index_s = time.perf_counter() - t0
        index = g._shards[0].fused_index
        if (index.group, index.bits) != (kw.get("group", 1), kw.get("bits", 8)):
            raise AssertionError(f"{label}: the index has group {index.group}, "
                                 f"bits {index.bits}")
        per_point = _nbytes(index) / n
        adjacency.launches = adjacency.launches_nibbles = 0
        best = sweep(g, ctx["query_dev"], ctx["base"], ctx["query"],
                     ctx["evaluator"], SWEEP, QKW, device, f"fused {label}",
                     reps=3, warmup=1)
        launches, nibbles = adjacency.launches, adjacency.launches_nibbles
        _launched(launches, f"the {label} fused queries", device)
        want = launches if label == "int4" else 0
        if device.type == "cuda" and nibbles != want:
            raise AssertionError(f"{label}: {nibbles} of {launches} launches in "
                                 f"nibbles mode, expected {want}")
        print(f"{label} layout: index {index_s:.2f} s | device bytes "
              f"{per_point:.1f} B/point | operating point {json.dumps(best)} | "
              f"kernel launches {launches} (nibbles {nibbles})", flush=True)
        real = kernel_on_real_anchors(device, g, ctx["query_dev"], best, label)
        out[label] = {**best, "index_s": index_s, "bytes_per_point": per_point,
                      "launches": launches, "launches_nibbles": nibbles,
                      "real": real}
    return out


def shards_path(device, n=N_SHARDED, n_shard=N_SHARD, nq=NQ):
    """Several shards on one card, out of core: at most MAX_DEVICE_SHARDS on
    the device and a host-RAM cap of about one shard's graph cache, so the
    rotation goes down to the disk tier. Build, fused index, brute force,
    the fused sweep; then the same operating point all resident and after
    store/load must return identical ids."""
    base, query = make_dataset(n, nq, d=D, seed=0)
    work = Path(tempfile.mkdtemp(prefix="ggnn_smoke_shards_"))
    g = GGNN(device=device)
    try:
        g.set_base(base)
        g.set_shard_size(n_shard)
        g.set_max_device_shards(MAX_DEVICE_SHARDS)
        cfg = GraphConfig.create(N=n_shard, D=D, KBuild=K_BUILD)
        # graph + fused meta of one shard, with room to spare: a second
        # shard's cache goes over the cap and spills
        cap = int(1.5 * (cfg.graph_size_bytes() + n_shard * 4 + 4096))
        g.set_cpu_memory_limit(cap)
        adjacency.launches = 0
        t0 = time.perf_counter()
        g.build(k_build=K_BUILD, tau_build=TAU_BUILD, refinement_iterations=2)
        build_s = time.perf_counter() - t0
        per_shard = [round(s["build_time_s"], 3) for s in g.last_build_stats["shards"]]
        launches_build = adjacency.launches
        print(f"sharded build: {build_s:.2f} s for N={n} as {g.num_shards} x "
              f"{n_shard} (per shard {per_shard} s) | host cap {cap} B | "
              f"kernel launches {launches_build}", flush=True)
        t0 = time.perf_counter()
        g.build_fused_index()
        index_s = time.perf_counter() - t0
        print(f"sharded fused index: {index_s:.2f} s", flush=True)
        evaluator, bf_s = ground_truth(g, base, query)
        query_dev = torch.from_numpy(query).to(device)
        adjacency.launches = 0
        before = dict(g.tier_stats)
        t0 = time.perf_counter()
        best = sweep(g, query_dev, base, query, evaluator, SWEEP, QKW, device,
                     "sharded fused", reps=3, warmup=1)
        sweep_s = time.perf_counter() - t0
        launches_query = adjacency.launches
        _launched(launches_build, "the sharded build", device)
        _launched(launches_query, "the sharded fused queries", device)
        stats = dict(g.tier_stats)
        in_sweep = {k: stats[k] - before[k] for k in stats}
        print(f"tier moves: whole run {json.dumps(stats)} | in the sweep "
              f"{json.dumps(in_sweep)} | stage-ins {in_sweep['stage_ins_s']:.3f} s "
              f"of the sweep's {sweep_s:.3f} s on the host clock", flush=True)
        if stats["spills"] <= 0 or stats["stage_ins"] <= 0 or stats["unspills"] <= 0:
            raise AssertionError(f"the rotation never reached the disk tier: {stats}")

        kw = dict(QKW, pops_per_iter=best["P"])
        args = (K_QUERY, best["tau"], best["iters"])
        rotated = g.query(query_dev, *args, **kw).ids
        g.set_max_device_shards(g.num_shards)
        resident = g.query(query_dev, *args, **kw).ids
        if not np.array_equal(rotated, resident):
            raise AssertionError("all-resident ids differ from the rotated run's: "
                                 f"{np.mean(np.any(rotated != resident, 1))} of rows")
        g.set_working_directory(work / "graph")
        t0 = time.perf_counter()
        g.store()
        store_s = time.perf_counter() - t0
    finally:
        g.close()
    try:
        g2 = GGNN(device=device)
        g2.set_base(base)
        g2.set_shard_size(n_shard)
        g2.set_working_directory(work / "graph")
        t0 = time.perf_counter()
        g2.load(K_BUILD)
        g2.build_fused_index()
        _sync(device)
        load_s = time.perf_counter() - t0
        reused = g2.tier_stats["sidecar_reuses"]
        if reused != g2.num_shards:
            raise AssertionError(f"{reused} of {g2.num_shards} sidecars reused")
        loaded = g2.query(query_dev, *args, **kw).ids
        if not np.array_equal(loaded, rotated):
            raise AssertionError("ids after store/load differ from the rotated run's")
        g2.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"sharded: ids identical rotated / all resident / after store+load; "
          f"store {store_s:.2f} s, load + index from {reused} sidecars "
          f"{load_s:.2f} s", flush=True)
    return {**best, "build_s": build_s, "build_s_per_shard": per_shard,
            "index_s": index_s, "bf_s": bf_s, "store_s": store_s,
            "load_s": load_s, "tier_stats": stats, "tier_stats_sweep": in_sweep,
            "sweep_s": sweep_s,
            "launches_build": launches_build, "launches_query": launches_query}


def cli_path(device, n=N_CLI, nq=NQ_CLI, n_shard=CLI_SHARD):
    """``python -m ggnn_torch.benchmark`` twice on fvecs files: the first run
    builds and stores the parts with their group-2 sidecars, the second
    loads them and reuses the sidecars. Returns each run's seconds."""
    repo = Path(__file__).resolve().parent
    base, query = make_dataset(n, nq, d=D, seed=1)
    work = Path(tempfile.mkdtemp(prefix="ggnn_smoke_cli_"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(repo), env.get("PYTHONPATH", "")) if p)
    out = {}
    try:
        store_fvecs(work / "base.fvecs", base)
        store_fvecs(work / "query.fvecs", query)
        argv = [sys.executable, "-m", "ggnn_torch.benchmark",
                "--base", str(work / "base.fvecs"),
                "--query", str(work / "query.fvecs"),
                "--gt", str(work / "gt.ivecs"),
                "--graph_dir", str(work / "graph"),
                "--shard_size", str(n_shard), "--fused_group", "2",
                "--device", device.type]
        for run, marker in (("build", "build:"), ("load", "loading graph from")):
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=repo, env=env, capture_output=True,
                                  text=True, timeout=600)
            out[run] = time.perf_counter() - t0
            lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
            print(f"CLI {run} run: exit {proc.returncode}, {out[run]:.2f} s",
                  flush=True)
            for ln in lines:
                print(f"  {ln}", flush=True)
            if proc.returncode:
                raise AssertionError(f"CLI {run} run failed:\n{proc.stderr[-4000:]}")
            c1 = [ln for ln in lines if ln.lstrip().startswith("c@1 ")]
            if len(c1) != 4 or marker not in proc.stderr:
                raise AssertionError(f"CLI {run} run: unexpected output\n"
                                     f"{proc.stderr[-4000:]}")
        if f"fused index: {n // n_shard} of {n // n_shard} shards from their " \
                "sidecars" not in proc.stderr:
            raise AssertionError("the CLI's load run did not reuse its sidecars")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


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
    # registers, shared and local (spill) bytes per kernel, and the I2F
    # count of its SASS, from the toolkit's cuobjdump
    resources, i2f = adjacency.kernel_resources(), "not available"
    if resources is None:
        resources = "not available"
    else:
        resources = {k: {f: r[f] for f in ("REG", "SHARED", "LOCAL", "STACK", "I2F")
                         if f in r} for k, r in resources.items()}
        i2f = sum(r.get("I2F", 0) for r in resources.values())
    print(f"kernel resources (cuobjdump -res-usage; LOCAL holds spills): "
          f"{json.dumps(resources)} | I2F instructions in the SASS "
          f"(cuobjdump -sass): {i2f}", flush=True)
    t0 = _phase("kernel build", t0)
    u8 = check_kernel(device, False, 48)
    int4 = check_kernel(device, True, 24)
    group2 = check_kernel(device, False, 96, Nb=N // 2)
    torch.cuda.empty_cache()
    t0 = _phase("kernel vs plain", t0)

    summary, ctx = main_path(device)
    t0 = _phase("fused path (build, index, ground truth, sweep)", t0)
    row = row_path(device, ctx)
    t0 = _phase("row engine sweep", t0)
    layouts = layouts_path(device, ctx)
    del ctx
    torch.cuda.empty_cache()
    t0 = _phase("group-2 and int4 layouts + fused sweeps", t0)
    start = ROW_SWEEP.index((row["tau"], row["iters"]))
    launches, f32 = other_build(device, "f32-fetch", N, NQ, start,
                                quantized_fetch=False)
    _not_launched(launches, "the f32-fetch build")
    torch.cuda.empty_cache()
    t0 = _phase("f32-fetch build + row sweep", t0)
    launches_descent, descent = other_build(
        device, "descent+walk", N_DESCENT, NQ, 0, dense_seed_merge=False,
        sym_mode="walk")
    _launched(launches_descent, "the descent build's quantized legs", device)
    torch.cuda.empty_cache()
    t0 = _phase("descent build + row sweep", t0)
    sharded = shards_path(device)
    torch.cuda.empty_cache()
    t0 = _phase("shards out of core (build, index, ground truth, sweep, "
                "store/load)", t0)
    cli = cli_path(device)
    t0 = _phase("benchmark CLI (build + store, load)", t0)
    print("summary: " + json.dumps({
        "fused": {k: summary[k] for k in ("tau", "iters", "P", "qps", "c1",
                                          "c10", "build_s", "profile")},
        "row": row,
        "layouts": {k: {f: v for f, v in r.items() if f != "real"}
                    for k, r in layouts.items()}, "f32_fetch_build": f32,
        "descent_walk_build": descent, "sharded": sharded, "cli_s": cli,
    }), flush=True)

    per_path = {
        "fused_path": summary["launches"],
        "group2_queries": layouts["group2"]["launches"],
        "int4_queries": layouts["int4"]["launches"],
        "int4_queries_nibbles": layouts["int4"]["launches_nibbles"],
        "descent_build": launches_descent,
        "sharded_build": sharded["launches_build"],
        "sharded_queries": sharded["launches_query"],
        "row_queries": 0, "f32_fetch_build": 0,
    }

    def numbers(r):
        return {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "bound_share", "bytes")}

    kernels = [{
        "name": "adjacency_dot",
        "route": "cuda",
        "source": "ggnn_torch/csrc/adjacency_dot.cu",
        "replaces": "ggnn_tpu/ops/adjacency_pallas.py:156",
        "launches": sum(v for k, v in per_path.items()
                        if k != "int4_queries_nibbles"),
        **numbers(u8),
        # no single PyTorch call computes the gather + per-row dot
        "library_ms": None,
        "int4": numbers(int4),
        "group2": numbers(group2),
        "real_anchors": {"group1": numbers(summary["real"]),
                         "group2": numbers(layouts["group2"]["real"]),
                         "int4": numbers(layouts["int4"]["real"])},
        "launches_per_path": per_path,
        "resources": resources,
        "i2f": i2f,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
