#!/usr/bin/env python3
"""The dedup kernel of this tree beside other builds of it, on one GPU.

    python3 dedup_bench.py [--source OTHER.cu ...] [--rounds 3]

``--source`` names another source with the same two C entry points
(``beam_dedup_launch``, ``beam_dedup_compact_launch``): an earlier revision
(``git show <rev>:ggnn_torch/csrc/beam_dedup.cu > old.cu``) or a copy with
one constant changed. Every build is compiled in parallel into
``build/kernels/variants/`` and prints its registers, shared and local
(spill) bytes. At each of ``chip_smoke.DEDUP_SHAPES`` (every walk's step
shape, inputs from ``chip_smoke.dedup_inputs``) each build runs through the
counted wrappers ``beam_dedup_mask`` / ``beam_dedup_compact`` with its entry
points swapped in and must equal the plain version in every entry of ``ok``
and ``packed``; then the builds are timed in turns (the order reversed
every round): the device ms per launch from a CUDA graph of
``chip_smoke.DEDUP_LAUNCHES`` captured launches (``chip_smoke.replay_ms``)
and the host path's ms (CUDA events around Python calls), beside the bytes
bound. Needs a CUDA device. The last line is one JSON object with every
number.
"""

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as smoke
from ggnn_torch.ops import beam
from ggnn_torch.utils import nvcc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="another source with the same C entry points")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or args.rounds < 1:
        sys.exit("dedup_bench: needs a CUDA device and --rounds >= 1")
    dev = torch.device("cuda", 0)
    labels = ["this tree", *args.source]
    sources = [beam.KERNEL_SOURCE, *map(Path, args.source)]
    out_dir = Path(__file__).resolve().parent / "build" / "kernels" / "variants"
    libs = [out_dir / f"dedup_v{i}.so" for i in range(len(sources))]
    with ThreadPoolExecutor(len(sources)) as pool:
        secs = list(pool.map(nvcc.compile_library, sources, libs))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report = {"smi": smi, "device": torch.cuda.get_device_name(0),
              "launches_per_graph": smoke.DEDUP_LAUNCHES, "variants": []}
    fns = []
    for label, lib, s in zip(labels, libs, secs):
        res = nvcc.kernel_resources(lib)
        print(f"build {label}: {s:.2f} s | resources "
              f"{json.dumps(res) if res is not None else 'not available'}",
              flush=True)
        report["variants"].append({"label": label, "build_s": s,
                                   "resources": res, "shapes": {}})
        fns.append(beam._bind(lib))

    for label, B, K, W, V, cap in smoke.DEDUP_SHAPES:
        with_valid = cap is not None
        st, cand, valid = smoke.dedup_inputs(dev, B, K, W, V, with_valid)
        want = beam.beam_dedup_mask_plain(st, cand, valid)
        want_packed = (None if cap is None else
                       beam.beam_compact_candidates_plain(cand, want, cap))
        nbytes, bound_ms = smoke.dedup_bound(B, K, W, V, cap, with_valid)

        def call():
            if cap is None:
                return beam.beam_dedup_mask(st, cand, valid), None
            return beam.beam_dedup_compact(st, cand, valid, cap)

        for fn, v in zip(fns, report["variants"]):
            beam._launch_fns = fn
            ok, packed = call()
            torch.cuda.synchronize()
            differ = int((ok != want).sum())
            if want_packed is not None:
                differ += int((packed != want_packed).sum())
            if differ:
                raise AssertionError(f"{v['label']} at {label} differs from the "
                                     f"plain version in {differ} entries")
            v["shapes"][label] = {"differing": differ, "ms": [], "host_ms": [],
                                  "bound_ms": bound_ms, "bytes": nbytes}
        for r in range(args.rounds):
            order = list(zip(fns, report["variants"]))
            for fn, v in order if r % 2 == 0 else order[::-1]:
                beam._launch_fns = fn
                e = v["shapes"][label]
                e["ms"].append(smoke.replay_ms(call, dev))
                e["host_ms"].append(smoke.time_ms(call, dev)[0])
        for v in report["variants"]:
            e = v["shapes"][label]
            e["median_ms"] = sorted(e["ms"])[len(e["ms"]) // 2]
            e["median_host_ms"] = sorted(e["host_ms"])[len(e["host_ms"]) // 2]
            e["share"] = bound_ms / e["median_ms"]
            print(f"{label:26s} {v['label']:40s} differing {e['differing']} | "
                  f"device ms {' '.join(f'{t:.4f}' for t in e['ms'])} | host "
                  f"path ms {' '.join(f'{t:.4f}' for t in e['host_ms'])} | "
                  f"bound {bound_ms:.4f} (bytes) | share {e['share']:.3f}",
                  flush=True)
        del st, cand, valid, want, want_packed
        torch.cuda.empty_cache()
    beam._launch_fns = None
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
