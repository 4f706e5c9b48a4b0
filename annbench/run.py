#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print one JSON line.

    python3 annbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program (``ggnn_torch``).
Untraced, the line's metrics are the cell's end-to-end metrics; traced,
its per-layer metrics, with the device's busy and window seconds and a
breakdown. The numbers compared with the reference, each beside its
limit, close the line (``checks``) and are the last lines on standard
error. Exits non-zero, printing no result, without enough CUDA devices,
without the program, or when the process holds JAX or the JAX package
once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# what must never load in the measured process, by whole top-level name
FORBIDDEN = {"jax", "jaxlib", "flax", "ggnn_tpu"}


def forbidden_modules(modules) -> list:
    """Names in ``modules`` whose top-level name is a forbidden one."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's kernel libraries live at one fixed place in the checkout
    os.environ["GGNN_TORCH_CACHE"] = str(CHECKOUT / "build" / "kernels")
    sys.path[0] = str(CHECKOUT)  # the checkout, not this script's folder
    import torch

    from annbench import harness, registry

    bench = registry.load_bench(CHECKOUT)
    chips = int(registry.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"annbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available", file=sys.stderr)
        return 2
    if not (CHECKOUT / "ggnn_torch" / "__init__.py").is_file():
        print(f"annbench: no program (ggnn_torch) in {CHECKOUT}", file=sys.stderr)
        return 2
    out, checks = harness.run_cell(bench, args.workload, seed=args.seed,
                                   seconds=args.seconds, trace=bool(args.trace),
                                   t_start=T_START)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"annbench: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
