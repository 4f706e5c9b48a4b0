#!/usr/bin/env python3
"""The sym pass's walk through both routes, in turns, on one GPU.

    python3 sym_bench.py [--n 262144] [--rounds 2]
    python3 sym_bench.py --root DIR [--n 262144]

Builds the smoke's descent + walk graph (``chip_smoke.py`` phase 8:
``dense_seed_merge=False``, ``sym_mode="walk"``, k_build=48, tau_build=0.5,
2 refinements) of ``--n`` points twice: with the sym walks on their
default route (the per-step loop, one live-count read per step) and on
CUDA graphs of 4 steps (one read per replay). For each build: its seconds,
its sym seconds per layer, its peak device memory (allocated and reserved,
the allocator's peaks), the memory still reserved after it, how many
times dead walk programs' pools were returned to the device, and a
SHA-256 digest of its graph's neighbour lists, which must be equal. Then the last layer-0 sym pass of the second
build runs again on its own input through the eager and the graph route
in turns, eager, graphs, graphs, eager, ``--rounds`` times: each pass's
seconds (host clock around a synchronise), peak device memory, live-count
reads and captures, and the rows of its new graph that differ from the
first pass's (must be 0). Then the pass's first walk chunk on each route
under ``torch.profiler`` (device busy ms and share, top 5 kernels) and
timed with CUDA events.

``--root DIR`` only builds, once, with the ``ggnn_torch`` and
``chip_smoke.py`` of the checkout in ``DIR`` (another commit of this
repository, e.g. the parent, unpacked with ``git archive``) on that
checkout's own sym route: the build's seconds, sym seconds, peak device
memory and digest, to set beside this checkout's.

Needs a CUDA device. The last line is one JSON object with every number.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from contextlib import nullcontext

import torch


def graph_digest(g):
    """SHA-256 of the first shard's neighbour lists, layer by layer."""
    h = hashlib.sha256()
    for t in g.get_graph(0).neighbors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def build(smoke, dev, n, record=None):
    """The descent + walk build of ``n`` points inside ``record`` (a
    context manager, or none); returns its numbers, the index and what
    ``record`` yielded."""
    from ggnn_torch import GGNN
    from ggnn_torch.utils import graphs

    base, _ = smoke.make_dataset(n, 10, d=128, seed=0)
    g = GGNN(device=dev)
    g.set_base(base)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    releases = graphs.stats().get("releases")
    t0 = time.perf_counter()
    with record if record is not None else nullcontext() as recorded:
        g.build(k_build=smoke.K_BUILD, tau_build=smoke.TAU_BUILD,
                refinement_iterations=2, dense_seed_merge=False,
                sym_mode="walk")
    torch.cuda.synchronize(dev)
    out = {"build_s": time.perf_counter() - t0,
           "peak_allocated": torch.cuda.max_memory_allocated(dev),
           "peak_reserved": torch.cuda.max_memory_reserved(dev),
           "allocated_before": before,
           "reserved_after": torch.cuda.memory_reserved(dev)}
    if releases is not None:  # a checkout that returns dead pools' memory
        out["pool_releases"] = graphs.stats()["releases"] - releases
    phases = g.last_build_stats["shards"][0]["phases"]
    out["sym_s"] = {k: v for k, v in phases.items() if k.startswith("sym[")}
    out["digest"] = graph_digest(g)
    return out, g, recorded


def show(label, b):
    print(f"build, {label}: {b['build_s']:.3f} s | sym s per layer "
          f"{json.dumps({k: round(v, 3) for k, v in b['sym_s'].items()})} | "
          f"peak allocated {b['peak_allocated']} B, reserved "
          f"{b['peak_reserved']} B (allocated before {b['allocated_before']} B)"
          f" | reserved after {b['reserved_after']} B | dead pools' memory "
          f"released {b.get('pool_releases', 'n/a')} times | graph digest "
          f"{b['digest'][:16]}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--root", default=None,
                    help="only build, with the package of this checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or args.rounds < 1:
        sys.exit("sym_bench: needs a CUDA device and --rounds >= 1")
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as smoke
    from ggnn_torch.utils import graphs

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out = {"device": smi, "n": args.n, "root": args.root}
    if args.root is not None:
        out["build"], _, _ = build(smoke, dev, args.n)
        show(f"checkout {args.root}", out["build"])
        print(json.dumps(out), flush=True)
        return

    out["builds"] = {}
    for label, route in (("eager", None), ("graphs", graphs.GRAPHS)):
        recorded = None  # the previous build's pass input goes first
        b, g, recorded = build(smoke, dev, args.n,
                               smoke.last_layer0_sym(route))
        out["builds"][label] = b
        show(f"sym walks on {label}", b)
        del g
    digests = {b["digest"] for b in out["builds"].values()}
    if len(digests) != 1:
        raise AssertionError("the builds' graphs differ between the routes")
    # the last layer-0 pass of the second build, as the smoke keeps it
    pass_args, kw = recorded["args"], recorded["kw"]
    out["passes"], out["chunk"] = [], {}
    labels = ["eager", "graphs", "graphs", "eager"] * args.rounds
    first = None
    for label in labels:
        route = graphs.EAGER if label == "eager" else graphs.GRAPHS
        [(new, st, sec, mem)] = smoke.sym_routes(dev, pass_args, kw, [route])
        first = new if first is None else first
        rows = int(torch.any(new != first, dim=1).sum())
        out["passes"].append({"route": label, "s": sec, "rows_differing": rows,
                              "live_reads": st["walk_live_reads"],
                              "captures": st["walk_graphs_captured"],
                              "walk_rows": st["walk_rows"], **mem})
        print(f"layer-0 pass, {label} route: {sec:.3f} s | live-count reads "
              f"{st['walk_live_reads']} | captures {st['walk_graphs_captured']} "
              f"| peak allocated {mem['peak_allocated']} B, reserved "
              f"{mem['peak_reserved']} B | rows differing from the first pass "
              f"{rows}", flush=True)
        if rows:
            raise AssertionError(f"the {label} route's graph differs in {rows} rows")
    for label in ("eager", "graphs"):
        route = graphs.EAGER if label == "eager" else graphs.GRAPHS
        chunk, pairs, reads = smoke.walk_chunk(dev, pass_args, kw, route)
        prof = smoke.profile_call(dev, chunk, f"sym walk chunk ({pairs} pairs, "
                                  f"{label} route)")
        ms, _ = smoke.time_ms(chunk, dev, reps=5, warmup=1)
        out["chunk"][label] = {"pairs": pairs, "ms": ms, "profile": prof}
        print(f"sym walk chunk, {label} route: {ms:.3f} ms (CUDA events, 5 "
              "calls)", flush=True)
        graphs.drop(*reads)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
