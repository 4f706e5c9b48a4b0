#!/usr/bin/env python
"""The PyTorch port with data that already lives on the card.

The port's counterpart of ``examples/device_data.py`` (the reference's
ggnn_main_gpu_data.cu / ggnn_pytorch_gpu_data.py) and of
``examples/torch_interop.py``: base and query are tensors made on the
device, and the results stay there as tensors
(``set_return_results_on_device``), so nothing crosses to the host.

    python examples/torch_port/device_data.py [--n 10000 --nq 1000]
                                              [--dim 128] [--device cuda]
"""

import argparse

import torch

from ggnn_torch import GGNN, Evaluator


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--nq", type=int, default=1_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--k_build", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    gen = torch.Generator(device=args.device).manual_seed(0)
    base = torch.rand((args.n, args.dim), generator=gen, device=args.device)
    query = torch.rand((args.nq, args.dim), generator=gen, device=args.device)

    g = GGNN(device=args.device)
    g.set_base(base)
    g.set_return_results_on_device()
    g.build(k_build=args.k_build, tau_build=0.5)

    ids, dists = g.query(query, k_query=10, tau_query=0.64, max_iterations=400)
    print("result device:", ids.device, dists.device)
    print("indices:", ids[:5])
    print("squared dists:", dists[:5])

    gt_ids, _ = g.bf_query(query, k_gt=100)
    # the evaluator counts on the host
    evaluator = Evaluator(base.cpu(), query.cpu(), gt_ids.cpu(), k_query=10)
    result = evaluator.evaluate_results(ids.cpu())
    print(result)
    return ids, dists, result


if __name__ == "__main__":
    main()
