"""Several devices in one process: the counterpart of the JAX package's
``parallel/sharded.py``.

The reference runs one ``shard_map`` program over a device mesh: every chip
walks its own shard and the per-chip top-k merges on the device by an
``all_gather`` and a ``top_k`` (``_merge_over_ici``). Here each shard's
walk runs on its own device, one thread per device -- the walk syncs the
host once per replay of its CUDA graphs, so one thread dispatching to
every device in turn would serialise them; shards that share a device walk
one after another on its thread, since a second thread there only contends
with the first for the interpreter lock. A thread captures its walks'
graphs on a side stream of its own (``ggnn_torch/utils/graphs.py``) -- and
the partials are copied to one device (the
first shard's unless given) and merged there by :func:`merge_over_devices`:
ids offset by ``shard_index * n_shard``, concatenated in shard order, then
a stable sort, so that among equal distances the lower shard goes first,
as ``lax.top_k`` keeps it.

Inputs are per-device lists (shard ``i``'s tensors on its device ``i``) in
place of a mesh and stacked arrays, so ``make_mesh`` and ``stack_shards``
have no counterpart. A list may name one device more than once (two slots
of one card). Every engine kwarg is forwarded as given: ``rerank`` and
``cap`` are not recomputed here, unlike the reference's
``sharded_fused_query``. There is no multi-process path, as in the
reference.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack

import torch

from ggnn_torch.config import DistanceMeasure, GraphConfig
from ggnn_torch.ops.bruteforce import bruteforce_knn
from ggnn_torch.query.ann import ann_query
from ggnn_torch.query.fused import fused_query

__all__ = [
    "merge_over_devices",
    "per_device",
    "run_on_devices",
    "sharded_query",
    "sharded_fused_query",
    "sharded_bf_query",
]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def run_on_devices(jobs, devices):
    """``jobs[i]()`` on ``devices[i]``, one thread each; returns the results
    in order.

    On CUDA a thread enters its device with a stream of its own, which
    first waits for the calling thread's stream there (the inputs it made)
    and is synchronised before the thread returns; the tensors of a result
    (in tuples and lists) are marked as used by the caller's stream, so
    that their memory is not handed to another stream while the caller
    still reads them."""
    callers = {d: torch.cuda.current_stream(d) for d in devices
               if d.type == "cuda"}

    def run(job, dev):
        if dev.type != "cuda":
            return job()
        with ExitStack() as stack:
            stack.enter_context(torch.cuda.device(dev))
            stream = torch.cuda.Stream(device=dev)
            stream.wait_stream(callers[dev])
            stack.enter_context(torch.cuda.stream(stream))
            out = job()
            stream.synchronize()
        for t in _tensors(out):
            t.record_stream(callers[dev])
        return out

    with ThreadPoolExecutor(max_workers=len(jobs),
                            thread_name_prefix="ggnn-device") as pool:
        futures = [pool.submit(run, job, dev) for job, dev in zip(jobs, devices)]
        return [f.result() for f in futures]


def _walk_per_device(jobs, devices):
    """``jobs[i]()`` on ``devices[i]``: one thread per distinct device, which
    runs that device's jobs in order. Returns the results in job order."""
    groups: dict = {}
    for i, dev in enumerate(devices):
        groups.setdefault(dev, []).append(i)
    outs = run_on_devices(
        [lambda idx=idx: [jobs[i]() for i in idx] for idx in groups.values()],
        list(groups))
    results = [None] * len(jobs)
    for idx, out in zip(groups.values(), outs):
        for i, r in zip(idx, out):
            results[i] = r
    return results


def merge_over_devices(partials, k: int, n_shard: int = 0, device=None):
    """The k smallest of every row over the partials [(ids, dists)], given
    in shard order, on ``device`` (default: the first partial's).

    ``n_shard`` > 0: the ids are shard-local and gain ``i * n_shard`` (the
    empty id -1 stays). The sort is stable: among equal distances the
    earlier column -- the lower shard, then the better rank -- goes first."""
    device = partials[0][0].device if device is None else torch.device(device)
    ids, dists = [], []
    for i, (pi, pd) in enumerate(partials):
        pi = pi.to(device)
        if n_shard and i:
            pi = torch.where(pi >= 0, pi + i * n_shard, pi)
        ids.append(pi)
        dists.append(pd.to(device))
    ids, dists = torch.cat(ids, dim=1), torch.cat(dists, dim=1)
    dists, order = torch.sort(dists, dim=1, stable=True)
    return torch.gather(ids, 1, order[:, :k]), dists[:, :k]


def per_device(query, devices) -> dict:
    """One copy of the query on each distinct device."""
    return {d: query.to(d) for d in dict.fromkeys(devices)}


def sharded_query(bases, graphs, cfg: GraphConfig, query, KQuery: int,
                  tau_query: float, max_iterations: int = 400,
                  measure: DistanceMeasure = DistanceMeasure.Euclidean, *,
                  base_sqs=None, pops_per_iter: int = 8,
                  fetch_cap_fraction: float = 0.75, device=None):
    """The row engine over one index sharded across devices: shard ``i``
    (``bases[i]``, ``graphs[i]``) walks on its own device, the partials
    merge on ``device``. Returns (ids [Q, KQuery] global, dists)."""
    devices = [b.device for b in bases]
    qs = per_device(query, devices)
    base_sqs = base_sqs or [None] * len(bases)

    def job(i):
        return lambda: ann_query(
            qs[devices[i]], bases[i], graphs[i], cfg, KQuery, tau_query,
            max_iterations, measure, base_sq=base_sqs[i],
            pops_per_iter=pops_per_iter, fetch_cap_fraction=fetch_cap_fraction)

    partials = _walk_per_device([job(i) for i in range(len(bases))], devices)
    return merge_over_devices(partials, KQuery, bases[0].shape[0],
                              device or devices[0])


def sharded_fused_query(bases, indexes, query, KQuery: int, tau_query: float,
                        max_iterations: int = 400,
                        measure: DistanceMeasure = DistanceMeasure.Euclidean, *,
                        base_sqs=None, pops_per_iter: int = 16,
                        num_seeds: int = 16, rerank: int | None = None,
                        cap: int | None = None, width: int | None = None,
                        chunk: int = 8192, compact_levels: int = 0,
                        seed_approx: bool = False, device=None):
    """The fused engine over one index sharded across devices: shard ``i``
    walks ``indexes[i]`` on its own device with exactly the kwargs given
    (None takes ``fused_query``'s default; ``seed_approx``: the TPU's
    approximate seeds), the partials merge on ``device``. Returns (ids [Q,
    KQuery] global, dists)."""
    devices = [b.device for b in bases]
    qs = per_device(query, devices)
    base_sqs = base_sqs or [None] * len(bases)

    def job(i):
        return lambda: fused_query(
            qs[devices[i]], indexes[i], bases[i], KQuery, tau_query,
            max_iterations, measure, base_sq=base_sqs[i], chunk=chunk,
            pops_per_iter=pops_per_iter, num_seeds=num_seeds, rerank=rerank,
            cap=cap, compact_levels=compact_levels, width=width,
            seed_approx=seed_approx)

    partials = _walk_per_device([job(i) for i in range(len(bases))], devices)
    return merge_over_devices(partials, KQuery, bases[0].shape[0],
                              device or devices[0])


def sharded_bf_query(bases, query, k: int,
                     measure: DistanceMeasure = DistanceMeasure.Euclidean, *,
                     device=None):
    """Exact kNN over a base sharded across devices: each shard's top
    ``min(k, n_shard)`` on its own device, merged to the best
    ``min(k, k_local * shards)`` on ``device``."""
    devices = [b.device for b in bases]
    qs = per_device(query, devices)
    n_shard = bases[0].shape[0]
    k_local = min(k, n_shard)

    def job(i):
        return lambda: bruteforce_knn(bases[i], qs[devices[i]], k_local, measure)

    partials = _walk_per_device([job(i) for i in range(len(bases))], devices)
    return merge_over_devices(partials, min(k, k_local * len(bases)), n_shard,
                              device or devices[0])
