"""Entry points of the port: one fused query tile and the dry run
over several device slots.

    python -m ggnn_torch.entry

runs :func:`entry` on the card and then :func:`dryrun_multichip` over 8
slots. They are the counterparts of the JAX package's ``__graft_entry__``
(``entry`` and ``dryrun_multichip``): the same synthetic inputs from the
same seed, the same knobs, the same steps. The JAX dry run re-runs itself
on a virtual-device CPU platform; here a slot list stands for the devices
(``n`` slots of one card, or of the CPU), so nothing is re-executed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ggnn_torch.build.construction import build_graph
from ggnn_torch.config import DistanceMeasure, GraphConfig
from ggnn_torch.ggnn import GGNN, _device
from ggnn_torch.parallel import sharded_bf_query, sharded_fused_query, sharded_query
from ggnn_torch.query.fused import FusedIndex, _fused_query_tile, build_fused_index

__all__ = ["entry", "dryrun_multichip"]


def _codes(rng, n: int, k: int, d: int, rows: int = 64) -> np.ndarray:
    """``rng.integers(0, 256, (n, k, d))`` as u8, drawn ``rows`` rows at a
    time: the same values as one draw, without the int64 table (8 bytes a
    code) on the host."""
    out = np.empty((n, k, d), np.uint8)
    for lo in range(0, n, rows):
        out[lo : lo + rows] = rng.integers(0, 256, size=(min(rows, n - lo), k, d))
    return out


def entry(device=None, *, n: int = 2048, batch: int = 256, k_build: int = 24):
    """One batched fused (quantized-adjacency) query tile over a synthetic
    ``n``-point index. Returns ``(fn, example_args)``; ``fn(*example_args)``
    returns (ids [batch, 10] i32, dists [batch, 10] f32).

    The index and queries are drawn from ``np.random.default_rng(0)`` in the
    JAX entry's order, so at the default sizes every input equals its input
    bit for bit (the norms it packs into ``meta`` are ``nbr_sq`` here).
    ``fn`` takes ``route=`` (``ggnn_torch.utils.graphs``): by default CUDA
    graphs on the card and the eager loop on the CPU. ``device``: the
    current CUDA device by default (raises without one).
    """
    dev = _device("cuda" if device is None else device)
    D, KQ, R = 128, 10, 64  # dims, k_query, seed representatives
    rng = np.random.default_rng(0)
    base = rng.normal(size=(n, D)).astype(np.float32)
    nbr_ids = rng.integers(0, n, size=(n, k_build)).astype(np.int32)
    codes = _codes(rng, n, k_build, D)
    nbr_sq = np.abs(rng.normal(size=(n, k_build)).astype(np.float32))
    rep_ids = rng.choice(n, R, replace=False).astype(np.int32)
    query = rng.normal(size=(batch, D)).astype(np.float32)

    def t(x):
        return torch.from_numpy(x).to(dev)

    base_t = t(base)
    base_sq = torch.sum(base_t * base_t, dim=-1)
    rep = t(rep_ids)
    index = FusedIndex(
        nbr_ids=t(nbr_ids),
        blocks=t(codes),
        nbr_sq=t(nbr_sq),
        group_of=torch.arange(n, dtype=torch.int32, device=dev),
        members=torch.arange(n, dtype=torch.int32, device=dev)[:, None],
        scale=torch.full((D,), 0.01, dtype=torch.float32, device=dev),
        zero=torch.full((D,), -1.0, dtype=torch.float32, device=dev),
        rep_ids=rep,
        rep_vecs=base_t[rep.long()],
        rep_sq=base_sq[rep.long()],
        nn1_stats=torch.tensor([0.5, 1.0], dtype=torch.float32, device=dev),
    )
    tau = torch.tensor(0.5, dtype=torch.float32, device=dev)
    width, vis_size = GraphConfig.query_beam_geometry(KQ, 200)

    def fn(q, idx, b, b_sq, tau_query, *, route=None):
        return _fused_query_tile(
            q, idx, b, b_sq, tau_query,
            width=width, vis_size=vis_size, k_query=KQ,
            measure=DistanceMeasure.Euclidean, max_iterations=200,
            pops_per_iter=8, num_seeds=16, rerank=32, cap=64,
            compact_levels=0, route=route,
        )

    return fn, (t(query), index, base_t, base_sq, tau)


def _slots(n: int, device) -> list[torch.device]:
    """``n`` slots: round-robin over the visible cards by default, else
    all on the device named."""
    if device is not None:
        return [_device(device)] * n
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not cards:
        _device("cuda")  # raises: no CUDA device
    return [torch.device("cuda", i % cards) for i in range(n)]


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The sharded index and query over ``n_devices`` slots at tiny shapes:
    one graph built on shard 0 and reused for every shard, a fused index
    per shard, the row, fused and brute-force queries per slot merged on
    the device (``parallel.sharded_*``), then ``GGNN`` end to end: a build
    with one worker per slot and a fused query through the device merge.

    Prints the OK line and returns the ids of the three sharded queries and
    of the ``GGNN`` query (numpy), the merge route, the build workers, the
    slots and the seconds."""
    t0 = time.perf_counter()
    slots = _slots(n_devices, device)
    N_shard, D, KB, KQ, NQ = 128, 32, 8, 4, 16
    cfg = GraphConfig.create(N=N_shard, D=D, KBuild=KB)
    rng = np.random.default_rng(0)
    base = rng.normal(size=(n_devices * N_shard, D)).astype(np.float32)
    query = torch.from_numpy(rng.normal(size=(NQ, D)).astype(np.float32))

    # one real build (shard 0) wires every shard; GGNN below builds them all
    bases = [torch.from_numpy(base[i * N_shard : (i + 1) * N_shard]).to(s)
             for i, s in enumerate(slots)]
    graph0, _ = build_graph(bases[0], cfg, 0.5, refinement_iterations=0, seed=0)
    graphs = [graph0.to(s) for s in slots]
    fused = [build_fused_index(b, g, cfg) for b, g in zip(bases, graphs)]

    out = {}
    for name, (ids, _) in (
            ("row_ids", sharded_query(bases, graphs, cfg, query, KQ, 0.7, 50)),
            ("fused_ids", sharded_fused_query(bases, fused, query, KQ, 0.7, 50)),
            ("bf_ids", sharded_bf_query(bases, query, KQ))):
        _expect(tuple(ids.shape) == (NQ, KQ), f"{name} of shape {tuple(ids.shape)}")
        out[name] = ids.cpu().numpy()

    g = GGNN(device=slots[0])
    try:
        g.set_devices(slots)
        g.set_base(base)
        g.build(k_build=KB, tau_build=0.5, refinement_iterations=0)
        workers = g.last_build_stats["num_build_workers"]
        _expect(workers == n_devices, f"{workers} build workers for "
                f"{n_devices} slots")
        g.build_fused_index(group=2)
        ids_api, _ = g.query(query.numpy(), KQ, tau_query=0.7,
                             max_iterations=50, engine="fused")
        _expect(g.last_merge_route == "devices",
                f"the query merged on the {g.last_merge_route}")
        _expect(ids_api.shape == (NQ, KQ), f"GGNN ids of shape {ids_api.shape}")
    finally:
        g.close()
    print(f"dryrun_multichip({n_devices}): OK -- sharded row+fused query + bf "
          "merged on the device; GGNN end-to-end (parallel build + device "
          "merge)", flush=True)
    return dict(out, ggnn_ids=np.asarray(ids_api), route=g.last_merge_route,
                workers=workers, slots=[str(s) for s in slots],
                seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    fn, args = entry()
    result = fn(*args)
    print("entry OK:", tuple(tuple(x.shape) for x in result), flush=True)
    dryrun_multichip(8)
