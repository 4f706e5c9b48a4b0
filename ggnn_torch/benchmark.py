"""GGNN benchmark CLI of the PyTorch port.

Mirrors the reference benchmark's flag surface and control flow
(examples/cpp-and-cuda/ggnn_benchmark.cpp:37-205): load base/query (TEXMEX
fvecs/bvecs or ANN-benchmarks HDF5), load-or-build-and-store the graph,
load-or-bruteforce-and-store the ground truth, then sweep tau_query --
either the default recall anchors or the full ``--grid_search``. With the
fused engine the stored parts carry their fused-index sidecars, which a
later run with the same ``--fused_group``/``--fused_bits`` reuses.

Usage:
    python -m ggnn_torch.benchmark --base sift_base.fvecs \
        --query sift_query.fvecs --gt sift_groundtruth.ivecs \
        [--graph_dir DIR] [--k_build 24] [--tau_build 0.5] [--grid_search] \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from ggnn_torch.config import DistanceMeasure
from ggnn_torch.dataset import load_hdf5_dataset, load_vecs, store_ivecs
from ggnn_torch.evaluator import Evaluator
from ggnn_torch.ggnn import GGNN
from ggnn_torch.utils.logging import set_log_level, vlog


def build_parser() -> argparse.ArgumentParser:
    # flag names follow ggnn_benchmark.cpp:37-50
    p = argparse.ArgumentParser(prog="ggnn_torch.benchmark", description=__doc__)
    p.add_argument("--base", required=True, help="base vectors (fvecs/bvecs/hdf5)")
    p.add_argument("--query", default="", help="query vectors (fvecs/bvecs)")
    p.add_argument("--gt", default="", help="ground-truth ids (ivecs)")
    p.add_argument("--subset", type=int, default=0, help="number of base vectors")
    p.add_argument("--graph_dir", default="", help="directory for graph files")
    p.add_argument("--k_build", type=int, default=24)
    p.add_argument("--tau_build", type=float, default=0.5)
    p.add_argument("--refinement_iterations", type=int, default=2)
    p.add_argument("--k_query", type=int, default=10)
    p.add_argument("--max_iterations", type=int, default=200)
    p.add_argument("--measure", default="euclidean", choices=["euclidean", "cosine"])
    p.add_argument("--shard_size", type=int, default=0)
    p.add_argument(
        "--device_ids", "--gpu_ids", dest="device_ids", default="",
        help="CUDA device indices, space/comma-separated (one is supported)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device to run on (cuda needs a card; cpu for tests)",
    )
    p.add_argument(
        "--grid_search", action="store_true",
        help="query over a wide range of tau_query values",
    )
    p.add_argument(
        "--engine", default="fused", choices=["fused", "row"],
        help="query engine: fused = quantized adjacency, "
        "row = f32 row gathers (reference memory envelope)",
    )
    p.add_argument(
        "--fused_group", type=int, default=1,
        help="fused index block grouping (2 pairs graph-nearest nodes)",
    )
    p.add_argument(
        "--fused_bits", type=int, default=8, choices=[4, 8],
        help="fused index code width (4 halves the inline-code bytes)",
    )
    p.add_argument("-v", "--verbose", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_log_level(args.verbose)
    measure = DistanceMeasure.parse(args.measure)

    gt = None
    if args.base.endswith((".hdf5", ".h5")):
        data = load_hdf5_dataset(args.base)
        base, query = data["train"], data["test"]
        gt = data.get("neighbors")
        if args.subset:
            base = base[: args.subset]
            gt = None  # a subset invalidates the packaged ground truth
    else:
        base = load_vecs(args.base, 0, args.subset or None)
        if not args.query:
            raise SystemExit("--query is required with TEXMEX base files")
        query = load_vecs(args.query)

    print(f"base: {base.shape} {base.dtype}, query: {query.shape}", file=sys.stderr)

    g = GGNN(device=args.device)
    if args.device_ids:
        g.set_gpus([int(x) for x in args.device_ids.replace(",", " ").split()])
    g.set_base(base)
    if args.shard_size:
        g.set_shard_size(args.shard_size)
    if args.graph_dir:
        g.set_working_directory(args.graph_dir)

    # load-or-build-and-store (ggnn_benchmark.cpp:150-161); the parts are
    # stored once the fused index exists, so that its sidecars go with them
    graph_file = Path(args.graph_dir) / "part_0.npz" if args.graph_dir else None
    loaded = graph_file is not None and graph_file.exists()
    if loaded:
        vlog(0, "loading graph from %s", args.graph_dir)
        g.load(args.k_build)
    else:
        t0 = time.perf_counter()
        g.build(args.k_build, args.tau_build,
                refinement_iterations=args.refinement_iterations, measure=measure)
        vlog(0, "build: %.3f s", time.perf_counter() - t0)

    # load-or-bruteforce-and-store ground truth (ggnn_benchmark.cpp:164-173)
    if gt is None:
        if args.gt and Path(args.gt).exists():
            gt = load_vecs(args.gt)
        else:
            vlog(0, "computing brute-force ground truth")
            gt, _ = g.bf_query(query, k_gt=max(100, args.k_query), measure=measure)
            if args.gt:
                store_ivecs(args.gt, np.asarray(gt))

    evaluator = Evaluator(base, query, gt=gt, k_query=args.k_query, measure=measure)

    if args.engine == "fused":
        reused = g.tier_stats["sidecar_reuses"]
        g.build_fused_index(group=args.fused_group, bits=args.fused_bits)
        vlog(0, "fused index: %d of %d shards from their sidecars",
             g.tier_stats["sidecar_reuses"] - reused, g.num_shards)
        # a rebuilt index replaces the stored sidecars of another layout
        loaded = loaded and g.tier_stats["sidecar_reuses"] - reused == g.num_shards
    if graph_file is not None and not loaded:
        Path(args.graph_dir).mkdir(parents=True, exist_ok=True)
        g.store()

    def run_query(tau_query: float):
        t0 = time.perf_counter()
        ids, _ = g.query(query, args.k_query, tau_query, args.max_iterations,
                         measure, engine=args.engine)
        dt = time.perf_counter() - t0
        print(f"-- tau_query {tau_query:.2f}, max_iterations {args.max_iterations}")
        print(f"   {query.shape[0] / dt:,.0f} QPS ({dt * 1e6 / query.shape[0]:.1f} "
              f"us/query, host clock, device {args.device})")
        print(evaluator.evaluate_results(ids), flush=True)

    if args.grid_search:
        # ggnn_benchmark.cpp:186-193
        for i in range(70):
            run_query(i * 0.01)
        for i in range(7, 21):
            run_query(i * 0.1)
    else:
        # the SIFT1M anchors (ggnn_benchmark.cpp:196-200)
        for tau in (0.34, 0.41, 0.51, 0.64):
            run_query(tau)
    g.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
