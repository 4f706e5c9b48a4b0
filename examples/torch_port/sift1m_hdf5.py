#!/usr/bin/env python
"""ANN-benchmarks HDF5 (sift-128-euclidean.hdf5) on the PyTorch port.

The port's counterpart of ``examples/sift1m_hdf5.py``: loads the
train/test/neighbors arrays of an ANN-benchmarks file (needs h5py) and
sweeps the reference's recall anchors.

Dataset: https://ann-benchmarks.com/sift-128-euclidean.hdf5, not
downloaded here.

    python examples/torch_port/sift1m_hdf5.py /path/to/sift-128-euclidean.hdf5
                                              [--device cuda]
"""

import argparse

from ggnn_torch import GGNN, Evaluator, load_hdf5_dataset

POINTS = ((0.34, 200), (0.41, 200), (0.51, 200), (0.64, 400))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="an ANN-benchmarks .hdf5 file")
    ap.add_argument("--k_build", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    data = load_hdf5_dataset(args.path)
    base, query, gt = data["train"], data["test"], data["neighbors"]

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
