#!/usr/bin/env python3
"""The approximate top-k kernel of this tree beside other builds of it, on
one GPU.

    python3 approx_bench.py [--source OTHER.cu ...] [--rounds 3]

``--source`` names another source with the same C entry point
(``approx_topk_launch``): an earlier revision (``git show
<rev>:ggnn_torch/csrc/approx_topk.cu > old.cu``) or a copy with one thing
changed. Every build is compiled in parallel into
``build/kernels/variants/`` and prints each kernel's registers, shared and
local (spill) bytes (``cuobjdump -res-usage``) and its load, store, shuffle
and barrier instructions by opcode (``cuobjdump -sass``; ``LDG.E.128`` is a
16-byte load). At each of ``chip_smoke.APPROX_SHAPES`` (Euclidean, and
cosine at ``chip_smoke.APPROX_COSINE``; inputs from
``chip_smoke.approx_inputs``) each build runs through the counted wrapper
``approx_smallest_k`` with its entry point swapped in and must equal the
plain version (``finish`` + ``approx_smallest_k_plain``): ids equal,
distances bit-equal (cosine within 2 ulp). Then the builds are timed in
turns, the order reversed every round: device ms per launch from a CUDA
graph of ``chip_smoke.DEDUP_LAUNCHES`` captured launches
(``chip_smoke.replay_ms``), beside the bytes bound
(``chip_smoke.approx_bound``). Needs a CUDA device. The last line is one
JSON object with every number.
"""

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as smoke
from ggnn_torch.config import DistanceMeasure
from ggnn_torch.ops import approx_topk
from ggnn_torch.ops.distance import finish
from ggnn_torch.utils import nvcc

# the opcodes counted in each kernel's SASS: global loads (LDG), async
# copies to shared memory (LDGSTS, the bulk UBLKCP), shared loads and
# stores, shuffles, barriers
OPCODES = ("LDG", "LDGSTS", "UBLKCP", "LDS", "STS", "SHFL", "BAR", "SYNCS")


def opcode_counts(sass):
    """{kernel: {opcode: count}} of ``OPCODES`` in ``cuobjdump -sass``."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            out[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and name is not None and m.group(1).split(".")[0] in OPCODES:
            out[name][m.group(1)] += 1
    return {k: dict(sorted(v.items())) for k, v in out.items()}


def sass_of(lib):
    tool = Path(nvcc.nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="another source with the same C entry point")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or args.rounds < 1:
        sys.exit("approx_bench: needs a CUDA device and --rounds >= 1")
    dev = torch.device("cuda", 0)
    labels = ["this tree", *args.source]
    sources = [approx_topk.KERNEL_SOURCE, *map(Path, args.source)]
    out_dir = Path(__file__).resolve().parent / "build" / "kernels" / "variants"
    libs = [out_dir / f"approx_v{i}.so" for i in range(len(sources))]
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
        ops = opcode_counts(sass_of(lib))
        print(f"build {label}: {s:.2f} s", flush=True)
        for name, r in (res or {}).items():
            print(f"  {name}: {json.dumps(r)} | {json.dumps(ops.get(name, {}))}",
                  flush=True)
        report["variants"].append({"label": label, "build_s": s,
                                   "resources": res, "opcodes": ops,
                                   "shapes": {}})
        fns.append(approx_topk._bind(lib))

    cases = [(label, B, n, k, rows, DistanceMeasure.Euclidean)
             for label, B, n, k, rows in smoke.APPROX_SHAPES]
    cases += [(f"{label}, cosine", B, n, k, rows, DistanceMeasure.Cosine)
              for label, B, n, k, rows in smoke.APPROX_SHAPES
              if label in smoke.APPROX_COSINE]
    try:
        for label, B, n, k, rows, measure in cases:
            dot, q_sq, c_sq = smoke.approx_inputs(dev, B, n, rows, measure)
            want_d, want_p = approx_topk.approx_smallest_k_plain(
                finish(dot, q_sq[:, None], c_sq[None, :], measure), k)
            tol = 0 if measure == DistanceMeasure.Euclidean else 2
            nbytes, bound_ms, bound_by = smoke.approx_bound(B, n, k)

            def call():
                return approx_topk.approx_smallest_k(dot, q_sq, c_sq, k, measure)

            for fn, v in zip(fns, report["variants"]):
                approx_topk._launch_fn = fn
                d, p = call()
                torch.cuda.synchronize()
                ids = int((p != want_p).sum())
                ulp = int((d.view(torch.int32).long()
                           - want_d.view(torch.int32).long()).abs().max())
                if ids or ulp > tol:
                    raise AssertionError(f"{v['label']} at {label} differs from "
                                         f"the plain version: {ids} ids, "
                                         f"distances up to {ulp} ulp")
                v["shapes"][label] = {"differing": ids, "max_ulp": ulp,
                                      "ms": [], "bound_ms": bound_ms,
                                      "bound_by": bound_by, "bytes": nbytes}
            for r in range(args.rounds):
                order = list(zip(fns, report["variants"]))
                for fn, v in order if r % 2 == 0 else order[::-1]:
                    approx_topk._launch_fn = fn
                    v["shapes"][label]["ms"].append(smoke.replay_ms(call, dev))
            for v in report["variants"]:
                e = v["shapes"][label]
                e["median_ms"] = sorted(e["ms"])[len(e["ms"]) // 2]
                e["share"] = bound_ms / e["median_ms"]
                print(f"{label:26s} B={B} n={n} k={k} {v['label']:34s} "
                      f"differing ids {e['differing']}, {e['max_ulp']} ulp | "
                      f"device ms {' '.join(f'{t:.4f}' for t in e['ms'])} | "
                      f"bound {bound_ms:.4f} ({bound_by}) | share "
                      f"{e['share']:.3f}", flush=True)
            del dot, q_sq, c_sq, want_d, want_p
            torch.cuda.empty_cache()
    finally:
        approx_topk._launch_fn = None
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
