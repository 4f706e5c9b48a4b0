#!/usr/bin/env python3
"""The adjacency kernel of this tree beside other builds of it, on one GPU.

    python3 adjacency_bench.py [--source OTHER.cu ...] [--rounds 3]

``--source`` names another source with the same C entry point: an earlier
revision (``git show <rev>:ggnn_torch/csrc/adjacency_dot.cu > old.cu``) or
a copy with one constant changed. Every build is compiled in parallel into
``build/kernels/variants/`` and prints its registers, shared and local
(spill) bytes and its SASS count of ``I2F*`` conversions. On the check
shapes of ``chip_smoke.py`` (B=8192 rows, D=128, ~10% empty anchors; P=8,
and P=4 as a fused walk step has) and the benchmark cells' step shapes
(``SHAPES``: sift1m's, deep1m's merge step, gist1m's, glove100's) each
build runs through the counted ``adjacency_dot`` with its entry point
swapped in, is held against the plain version (live lanes, rtol 1e-5 /
atol 1e-2) and against this tree's kernel bit for bit, then timed with
CUDA events in turns (the order reversed every round) beside the bound of
the call. Code rows of D % 16 != 0 bytes run another build only where its
resources name an ``adjacency_dot_*_tail_*`` kernel: a build without the
tail kernels would read those rows with misaligned 16-byte loads.
Needs a CUDA device. The last line is one JSON object with every number.
"""

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as smoke
from ggnn_torch.ops import adjacency

# (label, nibbles, code rows per block, blocks, anchors per row, query
# rows, code row bytes): the smoke's check shapes, then the cells' steps at
# k_build 24 -- a b10k query tile (8,192 rows, 8 pops; sift1m, glove100), a
# build merge chunk (8,192 rows, 8 pops; deep1m), gist1m's 1,024-row tile
# (16 pops)
SHAPES = [
    ("u8", False, 48, smoke.N, 8, 8192, smoke.D),
    ("int4", True, 24, smoke.N, 8, 8192, smoke.D),
    ("group2", False, 96, smoke.N // 2, 8, 8192, smoke.D),
    ("u8 P=4", False, 48, smoke.N, 4, 8192, smoke.D),
    ("int4 P=4", True, 24, smoke.N, 4, 8192, smoke.D),
    ("sift1m step", False, 24, smoke.N, 8, 8192, 128),
    ("deep1m merge step", False, 24, smoke.N, 8, 8192, 96),
    ("gist1m step", False, 24, smoke.N, 16, 1024, 960),
    ("glove100 step", False, 24, smoke.N, 8, 8192, 100),
    ("glove100 int4 step", True, 12, smoke.N, 8, 8192, 100),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="another source with the same C entry point")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or args.rounds < 1:
        sys.exit("adjacency_bench: needs a CUDA device and --rounds >= 1")
    dev = torch.device("cuda", 0)
    labels = ["this tree", *args.source]
    sources = [adjacency.KERNEL_SOURCE, *map(Path, args.source)]
    out_dir = Path(__file__).resolve().parent / "build" / "kernels" / "variants"
    libs = [out_dir / f"v{i}.so" for i in range(len(sources))]
    with ThreadPoolExecutor(len(sources)) as pool:
        secs = list(pool.map(adjacency._compile, sources, libs))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report = {"smi": smi, "device": torch.cuda.get_device_name(0), "variants": []}
    fns = []
    for k, (label, lib, s) in enumerate(zip(labels, libs, secs)):
        res = adjacency.kernel_resources(lib)
        # this tree's build has the tail kernels; another's, if cuobjdump
        # names one
        tail = k == 0 or any("_tail_" in name for name in res or {})
        print(f"build {label}: {s:.2f} s | tail kernels {tail} | resources "
              f"{json.dumps(res) if res is not None else 'not available'}",
              flush=True)
        report["variants"].append({"label": label, "build_s": s, "tail": tail,
                                   "resources": res, "shapes": {}})
        fns.append(adjacency._bind(lib))

    for name, nibbles, CR, Nb, P, B, D in SHAPES:
        qs, anchors, blocks = smoke.synthetic_inputs(dev, nibbles, CR, B=B, P=P,
                                                     Nb=Nb, D=D)
        nbytes, flops, bound_ms, bound_by = smoke.bound(anchors, blocks, nibbles)
        runs = [(fn, v) for fn, v in zip(fns, report["variants"])
                if D % 16 == 0 or v["tail"]]

        def call():
            return adjacency.adjacency_dot(qs, anchors, blocks, nibbles=nibbles)

        ref = adjacency.adjacency_dot_plain(qs, anchors, blocks, nibbles=nibbles)
        live = (anchors >= 0)[:, :, None].expand_as(ref)
        first = None
        for fn, v in runs:
            adjacency._launch_fn = fn
            out = call()
            torch.cuda.synchronize()
            err = float((out - ref).abs()[live].max())
            if not torch.allclose(out[live], ref[live], rtol=1e-5, atol=1e-2):
                raise AssertionError(f"{v['label']} on {name} disagrees with the "
                                     f"plain version: max abs err {err}")
            first = out if first is None else first
            v["shapes"][name] = {
                "max_abs_err": err, "ms": [], "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                "bit_identical_to_this_tree": torch.equal(out[live], first[live])}
        for r in range(args.rounds):
            for fn, v in runs if r % 2 == 0 else runs[::-1]:
                adjacency._launch_fn = fn
                v["shapes"][name]["ms"].append(smoke.time_ms(call, dev)[0])
        for _, v in runs:
            e = v["shapes"][name]
            e["median_ms"] = sorted(e["ms"])[len(e["ms"]) // 2]
            e["share"] = bound_ms / e["median_ms"]
            print(f"{name:9s} {v['label']:40s} max abs err {e['max_abs_err']:.6g} "
                  f"bit-identical {e['bit_identical_to_this_tree']} | ms "
                  f"{' '.join(f'{t:.4f}' for t in e['ms'])} | bound {bound_ms:.4f} "
                  f"({bound_by}) | share {e['share']:.3f}", flush=True)
        del qs, anchors, blocks, ref, out, first
        torch.cuda.empty_cache()
    adjacency._launch_fn = None
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
