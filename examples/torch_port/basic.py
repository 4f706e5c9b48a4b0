#!/usr/bin/env python
"""Minimal use of the PyTorch port: build, query, brute-force ground truth,
recall.

The port's counterpart of ``examples/basic.py`` (the reference's
ggnn_main.cpp / ggnn_pytorch.py): random vectors, k_build=24,
tau_build=0.5, recall@10 against brute force.

    python examples/torch_port/basic.py [--n 10000 --nq 1000 --dim 128]
                                        [--device cuda]
"""

import argparse

import numpy as np

from ggnn_torch import GGNN, Evaluator


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--nq", type=int, default=1_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--k_build", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(42)
    base = rng.random((args.n, args.dim), dtype=np.float32)
    query = rng.random((args.nq, args.dim), dtype=np.float32)

    g = GGNN(device=args.device)
    g.set_base(base)
    g.build(k_build=args.k_build, tau_build=0.5, refinement_iterations=2)

    k_query = 10
    ids, dists = g.query(query, k_query=k_query, tau_query=0.64, max_iterations=400)
    print("indices:", ids[:5], "\nsquared dists:", dists[:5], "\n")

    gt_ids, _ = g.bf_query(query, k_gt=100)
    evaluator = Evaluator(base, query, gt_ids, k_query=k_query)
    result = evaluator.evaluate_results(ids)
    print(result)
    return result


if __name__ == "__main__":
    main()
