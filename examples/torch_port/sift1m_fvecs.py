#!/usr/bin/env python
"""SIFT1M (TEXMEX fvecs) with the reference's recall anchors, on the
PyTorch port.

The port's counterpart of ``examples/sift1m_fvecs.py``: with the default
parameters on SIFT1M, tau_query 0.34 / 0.41 / 0.51 should reach roughly
90 / 95 / 99% C@1, and 0.64 with 400 iterations 99% C@10.

Dataset: http://corpus-texmex.irisa.fr/ (ANN_SIFT1M), not downloaded here.

    python examples/torch_port/sift1m_fvecs.py /path/to/sift [--device cuda]
"""

import argparse
from pathlib import Path

from ggnn_torch import GGNN, Evaluator, load_fvecs, load_ivecs

POINTS = ((0.34, 200), (0.41, 200), (0.51, 200), (0.64, 400))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default="data/sift",
                    help="directory of sift_base/query.fvecs and "
                         "sift_groundtruth.ivecs")
    ap.add_argument("--k_build", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    path = Path(args.path)
    base = load_fvecs(path / "sift_base.fvecs")
    query = load_fvecs(path / "sift_query.fvecs")
    gt = load_ivecs(path / "sift_groundtruth.ivecs")

    k_query = 10
    evaluator = Evaluator(base, query, gt=gt, k_query=k_query)

    g = GGNN(device=args.device)
    g.set_base(base)
    g.build(k_build=args.k_build, tau_build=0.5)

    results = []
    for tau_query, max_iterations in POINTS:
        ids, _ = g.query(query, k_query, tau_query, max_iterations)
        print(f"-- tau_query={tau_query}, max_iterations={max_iterations}")
        results.append(evaluator.evaluate_results(ids))
        print(results[-1])
    return results


if __name__ == "__main__":
    main()
