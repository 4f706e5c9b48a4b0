#!/usr/bin/env python
"""The PyTorch port over several devices.

The port's counterpart of ``examples/multi_device.py`` (the reference's
ggnn_main_multi_gpu.cpp / ggnn_pytorch_multi_gpu.py): the base is split
into shards that go to the slots of the device list, one build worker per
slot; queries run against every shard and the results merge. The slots are
the first 4 (or 2) cards, or two slots of one card where there is only
one, or two slots of the CPU with ``--device cpu``.

    python examples/torch_port/multi_device.py [--n 100000 --nq 10000]
                                               [--n_shard 25000] [--device cuda]
"""

import argparse

import numpy as np
import torch

from ggnn_torch import GGNN


def default_slots(device: str) -> list[str]:
    if device == "cpu":
        return ["cpu", "cpu"]
    n = torch.cuda.device_count()
    k = 4 if n >= 4 else 2 if n >= 2 else 0
    return [f"cuda:{i}" for i in range(k)] or ["cuda:0", "cuda:0"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--nq", type=int, default=10_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--n_shard", type=int, default=25_000)
    ap.add_argument("--k_build", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    base = rng.random((args.n, args.dim), dtype=np.float32)
    query = rng.random((args.nq, args.dim), dtype=np.float32)

    g = GGNN(device=args.device)
    g.set_devices(default_slots(args.device))
    g.set_base(base)
    g.set_shard_size(n_shard=args.n_shard)
    g.build(k_build=args.k_build, tau_build=0.5)
    print(f"{g.num_shards} shards on slots {[str(d) for d in g.devices]}, "
          f"{g.last_build_stats['num_build_workers']} build workers")

    ids, dists = g.query(query, k_query=10, tau_query=0.64, max_iterations=400)
    print(f"merged on the {g.last_merge_route}")
    print("indices:", ids[:5], "\nsquared dists:", dists[:5], "\n")
    return g, ids, dists


if __name__ == "__main__":
    main()
