"""``approx_topk_roofline``: the approximate top-k kernel's share of its
roofline, in %: the least time its launches could take
(``counts/approx_topk.approx_bound`` at the shapes each launch got) over
their device time. A launch's tile rows and representatives are the
dimensions of the seeding product (``aten::mm``, [B, D] x [D, n]) in the
same ``seed`` range; k is the configuration's ``num_seeds``."""

from annbench import tracing
from annbench.counts.approx_topk import approx_bound


def read(run):
    t = run.trace
    if t is None:
        return None
    k_cfg = int(run.config.get("engine_kwargs", {}).get("num_seeds", 0))
    bound_ms = kernel_ms = 0.0
    for _, dev, ops in tracing.range_work(t.events, "seed"):
        launches = [e for e in dev if e.get("cat") == "kernel"
                    and "approx_topk_kernel" in e.get("name", "")]
        dims = next((op["args"]["Input Dims"] for op in ops
                     if op.get("name") == "aten::mm"
                     and len(op.get("args", {}).get("Input Dims", [])) >= 2), None)
        if not launches or dims is None or not k_cfg:
            continue
        B, n = dims[0][0], dims[1][1]
        for e in launches:
            bound_ms += approx_bound(B, n, min(k_cfg, n))[1]
            kernel_ms += e.get("dur", 0.0) / 1e3
    return 100.0 * bound_ms / kernel_ms if kernel_ms else None
