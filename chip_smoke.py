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
5. One JSON line with the kernel's numbers, then the last line
   ``{"ok": true, "device": {...}}``.
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


def main_path(device, n=N, nq=NQ):
    """Build, index, ground truth and the query sweep. Returns a summary
    with the kernel's launch counts in the build and in the whole run."""
    base, query = make_dataset(n, nq, d=D, seed=0)
    g = GGNN(device=device)
    g.set_base(base)
    adjacency.launches = 0
    t0 = time.perf_counter()
    g.build(k_build=K_BUILD, tau_build=TAU_BUILD, refinement_iterations=2)
    build_s = time.perf_counter() - t0
    launches_build = adjacency.launches
    phases = g.last_build_stats["shards"][0]["phases"]
    kinds = {}
    for name, s in phases.items():
        kinds[name.split("[")[0]] = kinds.get(name.split("[")[0], 0.0) + s
    print(f"build: {build_s:.2f} s for N={n} ({build_s * 1e6 / n:.2f} us/point)"
          f" | by kind {json.dumps({k: round(v, 3) for k, v in kinds.items()})}",
          flush=True)
    print("build phases (s): " + json.dumps({k: round(v, 3) for k, v in phases.items()}),
          flush=True)

    t0 = time.perf_counter()
    g.build_fused_index(group=1)
    index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gt_ids, gt_d = g.bf_query(query, k_gt=100)
    bf_s = time.perf_counter() - t0
    if gt_ids.shape != (nq, 100) or not np.all(np.isfinite(gt_d)):
        raise AssertionError("brute force returned malformed ground truth")
    print(f"fused index: {index_s:.2f} s | brute force ({nq} x {n}, k=100): "
          f"{bf_s:.2f} s", flush=True)
    evaluator = Evaluator(base, query, gt_ids, k_query=K_QUERY)

    query_dev = torch.from_numpy(query).to(device)
    g.set_return_results_on_device(True)
    best = None
    for tau, iters, P in SWEEP:
        kw = dict(QKW, pops_per_iter=P)
        ms, res = time_ms(
            lambda: g.query(query_dev, K_QUERY, tau, iters, **kw), device,
            reps=5, warmup=2,
        )
        ids = res.ids.cpu().numpy()
        dists = res.dists.cpu().numpy()
        if ids.shape != (nq, K_QUERY) or not np.all(np.isfinite(dists)):
            raise AssertionError("query returned malformed results")
        ev = evaluator.evaluate_results(ids)
        qps = nq / (ms * 1e-3)
        print(f"query tau={tau} iters={iters} P={P}: c@1={ev.c1:.4f} "
              f"c@10={ev.cKQuery:.4f} qps={qps:.1f} ({ms:.3f} ms / {nq} queries)",
              flush=True)
        if ev.c1 >= TARGET_C1:
            best = {"tau": tau, "iters": iters, "P": P, "qps": qps,
                    "c1": ev.c1, "c10": ev.cKQuery}
            # the returned distances are the exact ones (re-ranked)
            row = ids[0][ids[0] >= 0]
            exact = np.sum((base[row] - query[0]) ** 2, axis=-1)
            if not np.allclose(dists[0][: len(row)], exact, rtol=1e-4, atol=1e-2):
                raise AssertionError("query distances are not the exact ones")
            break
    g.set_return_results_on_device(False)
    if best is None:
        raise AssertionError(f"no sweep point reached c@1 >= {TARGET_C1}")
    launches_total = adjacency.launches
    if launches_build <= 0:
        raise AssertionError("the build never launched the adjacency kernel")
    if launches_total <= launches_build:
        raise AssertionError("the queries never launched the adjacency kernel")
    print(f"operating point: {json.dumps(best)} | kernel launches: build "
          f"{launches_build}, queries {launches_total - launches_build}",
          flush=True)
    return {"launches": launches_total, "build_s": build_s, "bf_s": bf_s, **best}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    build_s = adjacency.build_kernel()
    print(f"kernel build: {build_s:.2f} s", flush=True)
    u8 = check_kernel(device, nibbles=False)
    check_kernel(device, nibbles=True)
    torch.cuda.empty_cache()

    summary = main_path(device)
    kernels = [{
        "name": "adjacency_dot",
        "route": "cuda",
        "source": "ggnn_torch/csrc/adjacency_dot.cu",
        "replaces": "ggnn_tpu/ops/adjacency_pallas.py:153",
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
