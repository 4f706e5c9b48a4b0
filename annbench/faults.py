#!/usr/bin/env python3
"""Faults planted under the harness, and their readings on the card.

    python3 annbench/faults.py --workload <cell> --seeds 11 12 13

Each fault breaks the timed path as a later change could:

* ``step_unchanged``: every step of the walk returns its state unchanged
  (``graphs.run_steps``, which drives the fused and the row walks, hands
  back its input; the row engine's two uncapped first steps run before
  it and still move the beam);
* ``one_step``: the walk stops after one step (``max_iterations`` equal to
  ``pops_per_iter``);
* ``fixed_seeds`` (fused engine only): the seeding returns the first
  ``num_seeds`` representatives of every query in place of the
  approximate top-k's;
* ``half_batch``: the second half of each batch gets the first half's
  answers;
* ``altered_answer``: one id of each answer is altered where it is
  returned.

For each seed the tool sets the cell up as a run does, answers one cycle of
the mix soundly and then under each fault, judges each cycle as a run
judges its answers, and prints one JSON line a (seed, fault) with the
numbers and ``correct``. A sound comparison reads ``true`` for ``sound``
and ``false`` for every fault. The benchmark's runs never run it.
"""

import argparse
import json
import os
import sys
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parents[1]


@contextmanager
def step_unchanged():
    """Every step of the walk returns its state unchanged."""
    from ggnn_torch.utils import graphs

    run_steps = graphs.run_steps

    def unchanged(step, carry, consts, live, *, it, steps, live_n, **kw):
        return carry, live, max(it, steps), live_n

    graphs.run_steps = unchanged
    try:
        yield
    finally:
        graphs.run_steps = run_steps


@contextmanager
def fixed_seeds():
    """The fused seeding returns the first ``k`` representatives of every
    query (with their true distances) instead of its nearest ones."""
    import torch

    from ggnn_torch.query import fused

    seeds = fused.dist_approx_smallest_k

    def first_k(q, c, k, measure=None, *, q_sq, c_sq):
        c_k = c[:k].to(torch.float32)
        d = q_sq[:, None] + c_sq[:k][None, :] - 2.0 * (q.to(torch.float32) @ c_k.T)
        pos = torch.arange(k, device=q.device, dtype=torch.int32)
        return d.clamp_min(0.0), pos.expand(q.shape[0], k).contiguous()

    fused.dist_approx_smallest_k = first_k
    try:
        yield
    finally:
        fused.dist_approx_smallest_k = seeds


def half_batch(ids, dists):
    """Only the first half of the rows answered; the rest repeat them."""
    half = (len(ids) + 1) // 2
    return (np.concatenate([ids[:half], ids[: len(ids) - half]]),
            np.concatenate([dists[:half], dists[: len(ids) - half]]))


def altered_answer(n_base: int):
    """A tamper that moves the first id of the middle row to the next
    base point."""
    def alter(ids, dists):
        ids = ids.copy()
        m = len(ids) // 2
        ids[m, 0] = (ids[m, 0] + 1) % n_base
        return ids, dists
    return alter


def plans(cfg: dict) -> dict:
    """fault name -> (context that plants it, operating point or None,
    tamper or None) for a configuration, ``sound`` first."""
    one = (cfg["tau_query"], cfg["pops_per_iter"], cfg["pops_per_iter"])
    out = {"sound": (nullcontext, None, None),
           "step_unchanged": (step_unchanged, None, None),
           "one_step": (nullcontext, one, None)}
    if cfg["engine"] == "fused":
        out["fixed_seeds"] = (fixed_seeds, None, None)
    out["half_batch"] = (nullcontext, None, half_batch)
    out["altered_answer"] = (nullcontext, None, altered_answer(int(cfg["n_base"])))
    return out


def readings(g, cfg: dict, mix: dict, base, pool, gt, faults=None):
    """(fault, the numbers compared) for one cycle of the mix answered by
    the built program ``g`` under each fault of :func:`plans` (or those
    named in ``faults``)."""
    from annbench import harness, reference

    for name, (plant, point, tamper) in plans(cfg).items():
        if faults is not None and name not in faults:
            continue
        with plant():
            call = harness.query_fn(g, cfg, pool, point, tamper=tamper)
            answered = [(lo, n, *call(lo, n)) for lo, n in harness.cycle(mix)]
        rows, ids, dists, canon, per_call = harness._answers(answered)
        recall = harness._recall(answered, canon, per_call, gt, harness.RECALL_K)
        yield name, reference.judge(base, pool, rows, ids, dists, cfg["limits"],
                                    recall=recall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    os.environ["GGNN_TORCH_CACHE"] = str(CHECKOUT / "build" / "kernels")
    sys.path[0] = str(CHECKOUT)
    import torch

    from annbench import data, harness, reference, registry

    if not torch.cuda.is_available():
        print("annbench faults: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    bench = registry.load_bench(CHECKOUT)
    cell = registry.cell(bench, args.workload)
    cfg, mix = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    for seed in args.seeds:
        base, pool = data.generate(cfg["data"], int(cfg["n_base"]), int(cfg["dim"]),
                                   int(mix["pool"]), seed, device)
        g, _ = harness.build_program(cfg, base, device)
        gt = reference.exact_knn(base, pool, harness.RECALL_K)[0].cpu().numpy()
        for name, checks in readings(g, cfg, mix, base, pool, gt):
            print(json.dumps({"workload": args.workload, "seed": seed, "fault": name,
                              "correct": reference.passed(checks), "checks": checks}),
                  flush=True)
        g.close()
        del g, base, pool
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
