#!/usr/bin/env python3
"""Find a configuration's operating point: the cheapest point of the sweep
whose c@1 reaches 0.90 on one seed.

    python3 annbench/sweep.py --config sift1m --traffic b10k [--seed 0]

Sets the program up as a run of the benchmark does, answers the mix's
pool once at each point of ``SWEEP`` (cheapest first; a copy of
``bench_torch.SWEEP``) after one warm-up pass, and prints one JSON line a
point: c@1 (the first id returned is the exact nearest), recall of the
exact 10 nearest, and queries per second over the timed pass. The
reference's exact neighbours are computed before the points are run.
The point it names is written into the configuration file by hand and
does not move after.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]

# (tau_query, max_iterations, pops_per_iter), cheapest first
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
TARGET_C1 = 0.90


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    os.environ["GGNN_TORCH_CACHE"] = str(CHECKOUT / "build" / "kernels")
    sys.path[0] = str(CHECKOUT)
    import torch

    from annbench import data, harness, reference, registry

    if not torch.cuda.is_available():
        print("annbench sweep: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    cfg, mix = registry.config(args.config), registry.traffic(args.traffic)
    base, pool = data.generate(cfg["data"], int(cfg["n_base"]), int(cfg["dim"]),
                               int(mix["pool"]), args.seed, device)
    g, build_s = harness.build_program(cfg, base, device)
    print(json.dumps({"config": args.config, "seed": args.seed, "build_s": build_s,
                      "device": torch.cuda.get_device_name(device)}), flush=True)
    gt = reference.exact_knn(base, pool, harness.RECALL_K)[0].cpu().numpy()
    plan = harness.cycle(mix)
    chosen = None
    for point in SWEEP:
        call = harness.query_fn(g, cfg, pool, point)
        for lo, n in plan:
            call(lo, n)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        answers = [(lo, n, call(lo, n)[0]) for lo, n in plan]
        elapsed = time.perf_counter() - t0
        rows = sum(n for _, n, _ in answers)
        c1 = sum(int((ids[:, 0] == gt[lo : lo + n, 0]).sum())
                 for lo, n, ids in answers) / rows
        hits = sum(int(reference.recall_hits(ids, gt[lo : lo + n]).sum())
                   for lo, n, ids in answers)
        line = {"tau_query": point[0], "max_iterations": point[1],
                "pops_per_iter": point[2], "c1": c1,
                "recall_at_10": hits / (rows * harness.RECALL_K),
                "qps": rows / elapsed}
        if chosen is None and c1 >= TARGET_C1:
            chosen = point
            line["chosen"] = True
        print(json.dumps(line), flush=True)
        del answers, call
    g.close()
    print(json.dumps({"operating_point": chosen}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
