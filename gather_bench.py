#!/usr/bin/env python3
"""The walks' fused gather + distance kernel of this tree beside other
builds of it, on one GPU.

    python3 gather_bench.py [--source OTHER.cu ...] [--rounds 3]

``--source`` names another source with the same C entry point
(``gather_dist_launch``): an earlier revision (``git show
<rev>:ggnn_torch/csrc/gather_dist.cu > old.cu``) or a copy with one
constant changed. Every build is compiled in parallel into
``build/kernels/variants/`` and prints its registers, shared and local
(spill) bytes (``cuobjdump -res-usage``). At each of
``chip_smoke.GATHER_SHAPES`` (the walks' step shapes and the CPU tests'
edge cases; inputs from ``chip_smoke.gather_inputs``) each build runs
through the counted wrapper ``gather_dist`` with its entry point swapped
in and is held against the plain version (the gather, cuBLAS's einsum,
``finish``): base ids equal, every distance within
``gather_dist.error_bound``, and its distances without base ids equal to
those with them. Then the builds are timed in turns in the walks' form
(no base ids written), the order reversed every round: device ms per launch from a CUDA graph of
``chip_smoke.DEDUP_LAUNCHES`` captured launches (``chip_smoke.replay_ms``),
beside the plain version's ms, ``torch.bmm`` alone on rows gathered
beforehand, and the bytes bound (``chip_smoke.gather_bound``: each input
byte once, distinct rows). Needs a CUDA device. The last line is one JSON
object with every number.
"""

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as smoke
from ggnn_torch.config import DistanceMeasure
from ggnn_torch.ops import gather_dist
from ggnn_torch.utils import nvcc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="another source with the same C entry point")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or args.rounds < 1:
        sys.exit("gather_bench: needs a CUDA device and --rounds >= 1")
    dev = torch.device("cuda", 0)
    labels = ["this tree", *args.source]
    sources = [gather_dist.KERNEL_SOURCE, *map(Path, args.source)]
    out_dir = Path(__file__).resolve().parent / "build" / "kernels" / "variants"
    libs = [out_dir / f"gather_v{i}.so" for i in range(len(sources))]
    with ThreadPoolExecutor(len(sources)) as pool:
        secs = list(pool.map(nvcc.compile_library, sources, libs))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report = {"smi": smi, "device": torch.cuda.get_device_name(0),
              "launches_per_graph": smoke.DEDUP_LAUNCHES, "variants": [],
              "shapes": {}}
    fns = []
    for label, lib, s in zip(labels, libs, secs):
        res = nvcc.kernel_resources(lib)
        print(f"build {label}: {s:.2f} s | resources "
              f"{json.dumps(res) if res is not None else 'not available'}",
              flush=True)
        report["variants"].append({"label": label, "build_s": s,
                                   "resources": res, "shapes": {}})
        fns.append(gather_dist._bind(lib))

    for label, B, K, Q, dtype, dim, measure, n_base, translated in smoke.GATHER_SHAPES:
        measure = DistanceMeasure[measure.capitalize()]
        qs, q_sq, ids, base, base_sq, tr = smoke.gather_inputs(
            dev, B, K, Q, dtype, dim, n_base, translated)
        want_d, want_ids = gather_dist.gather_dist_plain(qs, q_sq, ids, base,
                                                         base_sq, tr, measure)
        bound = gather_dist.error_bound(q_sq, base_sq[want_ids], dim, measure)
        elem = 1 if dtype == "u8" else 4
        nbytes, _, bound_ms, _ = smoke.gather_bound(ids, tr, dim, elem, Q)

        def call(with_ids=False):  # timed in the walks' form: no base ids
            return gather_dist.gather_dist(qs, q_sq, ids, base, base_sq, tr,
                                           measure, with_ids=with_ids)

        for fn, v in zip(fns, report["variants"]):
            gather_dist._launch_fn = fn
            d, got_ids = call(with_ids=True)
            same = torch.equal(call()[0], d)
            torch.cuda.synchronize()
            ratio = float(((d - want_d).abs() / bound).max())
            if not torch.equal(got_ids, want_ids) or ratio > 1.0 or not same:
                raise AssertionError(f"{v['label']} at {label}: base ids equal "
                                     f"{torch.equal(got_ids, want_ids)}, largest "
                                     f"error / bound {ratio}, without base ids "
                                     f"equal to with them {same}")
            v["shapes"][label] = {"max_err_ratio": ratio, "ms": [],
                                  "bound_ms": bound_ms, "bytes": nbytes}
        del d, got_ids, bound
        vecs = base[want_ids].to(torch.float32)
        q_t = qs.transpose(1, 2)
        del want_d, want_ids
        for r in range(args.rounds):
            order = list(zip(fns, report["variants"]))
            for fn, v in order if r % 2 == 0 else order[::-1]:
                gather_dist._launch_fn = fn
                v["shapes"][label]["ms"].append(smoke.replay_ms(call, dev))
        plain_ms, _ = smoke.time_ms(lambda: gather_dist.gather_dist_plain(
            qs, q_sq, ids, base, base_sq, tr, measure), dev)
        bmm_ms, _ = smoke.time_ms(lambda: torch.bmm(vecs, q_t), dev)
        report["shapes"][label] = {"plain_ms": plain_ms, "bmm_ms": bmm_ms,
                                   "bound_ms": bound_ms}
        for v in report["variants"]:
            e = v["shapes"][label]
            e["median_ms"] = sorted(e["ms"])[len(e["ms"]) // 2]
            e["share"] = bound_ms / e["median_ms"]
            print(f"{label:28s} {v['label']:32s} error / bound "
                  f"{e['max_err_ratio']:.4f} | device ms "
                  f"{' '.join(f'{t:.4f}' for t in e['ms'])} | bound "
                  f"{bound_ms:.4f} (bytes) | share {e['share']:.3f} | plain "
                  f"{plain_ms:.4f} ms | torch.bmm on pre-gathered rows "
                  f"{bmm_ms:.4f} ms", flush=True)
        del qs, q_sq, ids, base, base_sq, tr, vecs, q_t
        torch.cuda.empty_cache()
    gather_dist._launch_fn = None
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
