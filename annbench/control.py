#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the reference
itself, computed in the nearest precision below the configuration's
(TF32 for its float32), put in the program's place.

    python3 annbench/control.py --workload <cell> --seeds 11 12 13

For each seed it draws the cell's base and pool as a run does, answers
one cycle of the mix (every pool row once) by :func:`reference.exact_knn`
with ``tf32=True``, judges those answers as a run judges the program's,
and prints one JSON line a seed with the numbers and ``correct``. A sound
comparison reads ``false`` on every seed. The benchmark's runs never run
it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def control_checks(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The numbers compared when the control answers the cell's pool."""
    from annbench import data, harness, reference

    base, pool = data.generate(cfg["data"], int(cfg["n_base"]), int(cfg["dim"]),
                               int(mix["pool"]), seed, device)
    k = int(cfg["k_query"])
    gt = reference.exact_knn(base, pool, harness.RECALL_K)[0].cpu().numpy()
    answered = []
    for lo, n in harness.cycle(mix):
        i, d = reference.exact_knn(base, pool[lo : lo + n], k, tf32=True)
        answered.append((lo, n, i.cpu().numpy(), d.cpu().numpy()))
    rows, ids, dists, canon, per_call = harness._answers(answered)
    recall = harness._recall(answered, canon, per_call, gt, harness.RECALL_K)
    return reference.judge(base, pool, rows, ids, dists, cfg["limits"],
                           recall=recall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[0] = str(CHECKOUT)
    import torch

    from annbench import reference, registry

    if not torch.cuda.is_available():
        print("annbench control: no CUDA device", file=sys.stderr)
        return 2
    bench = registry.load_bench(CHECKOUT)
    cell = registry.cell(bench, args.workload)
    cfg, mix = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control_checks(cfg, mix, seed, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": reference.passed(checks), "checks": checks,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
