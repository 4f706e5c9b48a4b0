"""Public GGNN API of the PyTorch port: shards over device slots, out of core.

Equivalent of the reference's ``GGNN`` facade + ``GPUInstance`` runtime
(src/ggnn/base/ggnn.cu:53-564, src/ggnn/base/gpu_instance.cu:136-790):

* The base is split into ``N_shard``-sized shards with independent graphs
  (the reference's "multi-GPU through sharding", README.md:4-5), shard
  ``i`` built from seed ``1234 + i``. The shards go in contiguous blocks to
  the *slots* of the device list (``set_devices``; one slot by default).
  Shard ownership is keyed by slot, so two slots may name one device (two
  slots of one card, or of the CPU), where the JAX package would collapse
  them into one; the results are the same either way.
* ``build`` runs one worker thread per slot (the reference's one thread per
  GPU, ggnn.cu:222-230), on CUDA each with a stream of its own.
* Shards that do not all fit in device memory rotate through their device:
  device -> host RAM -> ``part_<id>.npz`` files (the reference's GPU /
  pinned-CPU / disk swapping, gpu_instance.cu:371-467). An evicted fused
  index keeps only its meta (group matching + quantizer) and is
  re-assembled at stage-in. Device transfers run on the calling thread, in
  its stream's order; a thread pool does the disk I/O (spills, the next
  shard's read-back, store/load) and the host merge of ``query_async``.
* Results merge by one of three routes (``last_merge_route``): one slot's
  shards on its device with a stable sorted top-k (the reference's per-GPU
  segmented sort, gpu_instance.cu:745-790); with several slots that each
  hold one resident shard, every shard walks on its own device, one
  thread per device, and the partials merge on the first slot's device
  (``parallel/sharded.py``, the JAX package's on-device merge;
  ``set_device_merge(False)`` turns it off); otherwise on the host, by the
  native k-way merger (``native/merge.py``, result_merger.cpp:79-142) or,
  where that is not built, numpy's stable sort. All three keep the same tie
  order, so they return the same ids.
"""

from __future__ import annotations

import os
import shutil
from collections import Counter
import tempfile
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ggnn_torch.build.construction import build_graph
from ggnn_torch.config import MAX_KQUERY, DistanceMeasure, GraphConfig
from ggnn_torch.dataset import Dataset
from ggnn_torch.graph import Graph, load_graph_shard, save_graph_shard
from ggnn_torch.native import merge as native_merge
from ggnn_torch.ops.bruteforce import bruteforce_knn
from ggnn_torch.ops.distance import squared_norms
from ggnn_torch.query.ann import ann_query
from ggnn_torch.query.fused import (
    FusedIndexMeta,
    assemble_fused_index,
    build_fused_index,
    fused_index_matches_graph,
    fused_query,
    load_fused_index,
    meta_of,
    save_fused_index,
)
from ggnn_torch.parallel.sharded import (
    merge_over_devices,
    per_device,
    run_on_devices,
    sharded_bf_query,
    sharded_fused_query,
    sharded_query,
)
from ggnn_torch.utils import graphs
from ggnn_torch.utils.logging import logger, vlog
from ggnn_torch.utils.spans import span

__all__ = ["GGNN", "Results", "ResultsFuture"]


class Results(tuple):
    """(ids, dists) pair with attribute access, like the reference Results
    (dataset.cuh:162-166)."""

    def __new__(cls, ids, dists):
        return super().__new__(cls, (ids, dists))

    @property
    def ids(self):
        return self[0]

    @property
    def dists(self):
        return self[1]


class ResultsFuture:
    """Handle for a :meth:`GGNN.query_async` batch; ``result()`` returns the
    :class:`Results` (copying them to the host unless results stay on the
    device)."""

    def __init__(self, resolve):
        self._resolve = resolve
        self._res = None

    def result(self) -> Results:
        if self._resolve is not None:
            self._res = self._resolve()
            self._resolve = None
        return self._res


def _as_tensor(data, device=None) -> torch.Tensor:
    """A contiguous float32/uint8 tensor (float64 is downcast), on
    ``device`` if one is given, else where it lies (numpy: the host)."""
    if isinstance(data, Dataset):
        data = data.data
    t = data if isinstance(data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(data))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    if device is not None:
        t = t.to(device)
    return t.contiguous()


def _signature(tensors: dict) -> tuple:
    return tuple((k, tuple(t.shape), t.dtype, str(t.device))
                 for k, t in tensors.items())


def _device(device) -> torch.device:
    """A device the caller named, with its index on CUDA; raises where there
    is no such CUDA device (there is no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"GGNN(device={str(device)!r}): no CUDA device "
                               "is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"GGNN(device={str(device)!r}): only "
                               f"{torch.cuda.device_count()} CUDA devices")
    return device


class _Shard:
    """One base shard + its graph and fused index in their tiers. A shard
    that rotates keeps the tensors its walks read in *buffers* (the
    reference's GPUBuffer, gpu_instance.cuh:136-178): device tensors that
    the next shard staged in with the same shapes overwrites once this one
    is evicted."""

    # the fused index's tables a walk reads (query/fused.py:_walk)
    WALKED = ("nbr_ids", "blocks", "nbr_sq", "group_of", "scale", "zero")

    def __init__(self, shard_id: int, slot: int, device: torch.device,
                 base_host):
        self.shard_id = shard_id
        self.slot = slot  # index into GGNN's device list
        self.device = device
        self.base_host = base_host
        self.base_dev = None
        self.base_sq = None
        self.graph: Graph | None = None
        self.graph_host: Graph | None = None
        self.fused_index = None
        self.fused_index_host: FusedIndexMeta | None = None
        self.quantizer = None  # (scale, zero) the build fitted at 255 levels
        self.spilled = False  # host cache pushed down to part_*.npz files
        self.spilled_fused = False  # ... with a fused sidecar
        self.spill_dir: Path | None = None
        self._pending = None  # in-flight disk I/O on this shard
        self.buffers: dict | None = None  # name -> device tensor, see walked()

    @property
    def resident(self) -> bool:
        return self.graph is not None

    @property
    def has_fused_index(self) -> bool:
        return (self.fused_index is not None or self.fused_index_host is not None
                or (self.spilled and self.spilled_fused))

    def wait(self):
        """Join the disk I/O in flight on this shard (gpu_instance.cu:362-368
        waitForPart)."""
        if self._pending is not None:
            fut, self._pending = self._pending, None
            fut.result()

    def ensure_base(self):
        if self.base_dev is None:
            self.base_dev = self.base_host.to(self.device)
            self.base_sq = squared_norms(self.base_dev)

    def ensure_graph(self):
        if self.graph is None:
            if self.graph_host is None:
                raise RuntimeError(f"shard {self.shard_id}: no graph available")
            self.graph = self.graph_host.to(self.device)

    def ensure_fused_index(self):
        """The device index; re-assembled from the host meta (one device
        gather, bit-identical) when only the meta is left."""
        if self.fused_index is None and self.fused_index_host is not None:
            self.ensure_base()
            self.ensure_graph()
            m = self.fused_index_host
            self.fused_index = assemble_fused_index(
                self.base_dev, self.graph, members=m.members, scale=m.scale,
                zero=m.zero, bits=int(m.bits[0]))
        return self.fused_index

    def host_cache_bytes(self) -> int:
        """Host RAM of the cached graph + fused meta (what
        set_cpu_memory_limit bounds, gpu_instance.cu:196-227)."""
        graph, meta = self.graph_host, self.fused_index_host
        total = graph.nbytes() if graph is not None else 0
        if meta is not None:
            total += sum(np.asarray(x).nbytes for x in meta)
        return total

    def walked(self) -> dict:
        """The device tensors the walks read by address -- their captured
        graphs are keyed on them (``utils/graphs.py``): the base, its norms,
        layer 0 of the graph and, when they were assembled from the host
        meta, the fused index's tables."""
        out = {"base": self.base_dev, "base_sq": self.base_sq,
               "nbr0": self.graph.neighbors[0]}
        if self.fused_index is not None and self.fused_index_host is not None:
            out.update((k, getattr(self.fused_index, k)) for k in self.WALKED)
        return out

    def occupy(self, buffers: dict) -> None:
        """Copy the walked tensors into ``buffers`` (the same names, shapes
        and dtypes) and read them from there on."""
        for k, t in self.walked().items():
            if buffers[k] is not t:
                buffers[k].copy_(t)
        self.base_dev, self.base_sq = buffers["base"], buffers["base_sq"]
        self.graph = self.graph._replace(
            neighbors=(buffers["nbr0"], *self.graph.neighbors[1:]))
        if "blocks" in buffers:
            self.fused_index = self.fused_index._replace(
                **{k: buffers[k] for k in self.WALKED})
        self.buffers = buffers

    def evict(self):
        """Swap the shard out of device memory, keeping a host copy of the
        graph and the fused index's meta (gpu_instance.cu:371-420). Returns
        the buffers it leaves, if any."""
        # the tensors may come from a build worker's stream: no stream may
        # still read them when their memory goes back to its pool
        graphs.synchronize(self.device)
        if self.graph is not None and self.graph_host is None:
            self.graph_host = self.graph.to("cpu")
        if self.fused_index is not None and self.fused_index_host is None:
            self.fused_index_host = meta_of(self.fused_index, self.graph_host)
        self.graph = None
        self.base_dev = None
        self.base_sq = None
        self.fused_index = None
        buffers, self.buffers = self.buffers, None
        return buffers


class GGNN:
    """Graph-based nearest-neighbor search in shards, on one device or
    several.

    Usage matches the reference Python bindings::

        g = GGNN(device="cuda")
        g.set_base(base)                       # np/torch [N, D] float32 or uint8
        g.set_shard_size(n_shard)              # optional; N % n_shard == 0
        g.build(k_build=24, tau_build=0.5)
        ids, dists = g.query(queries, 10, tau_query=0.5)   # row engine
        g.build_fused_index()
        ids, dists = g.query(queries, 10, tau_query=0.5, engine="fused")
        gt_ids, gt_dists = g.bf_query(queries, k_gt=100)
        g.set_devices(["cuda:0", "cuda:1"])    # several slots (before build)

    ``device="cuda"`` needs a CUDA device and raises without one; it never
    carries on on the CPU. ``tier_stats`` counts the out-of-core moves
    (evictions, spills to disk, read-backs, stage-ins, reused sidecars) and
    their seconds.
    """

    # engine-specific query kwargs: the engines that take each, and its
    # default. Passing one that does not apply to the selected engine raises
    # instead of being silently ignored. ``seed_approx`` (the JAX package's
    # default, True) picks the fused seeds as the TPU's ``approx_min_k``
    # does, on every route: one slot, the device and the host merge, the
    # out-of-core rotation.
    _ENGINE_KWARGS = {
        "pops_per_iter": (("row", "fused"), 8),
        "fetch_cap_fraction": (("row",), 0.75),
        "num_seeds": (("fused",), 16),
        "rerank": (("fused",), None),
        "cap": (("fused",), None),
        "chunk": (("fused",), 8192),
        "compact_levels": (("fused",), 2),
        "seed_approx": (("fused",), True),
        "width": (("fused",), None),
    }

    def __init__(self, device="cuda"):
        self._devices = [_device(device)]  # one entry per slot
        self._base: torch.Tensor | None = None
        self._n_shard = 0
        self._shards: list[_Shard] = []
        # buffers evicted shards left, for the next shard staged in
        self._free_buffers: list[dict] = []
        self._cfg: GraphConfig | None = None
        self._measure = DistanceMeasure.Euclidean
        self._build_seed = 1234
        self._working_dir: Path | None = None
        self._return_results_on_device = False
        self._cpu_memory_limit: int | None = None
        self._reserved_device_memory = 0
        self._max_device_shards: int | None = None  # None = from device memory
        self._back_to_front = False
        self._device_merge = True
        self.last_merge_route: str | None = None  # "device", "devices", "host"
        self._pool: ThreadPoolExecutor | None = None
        self._tmp_spill_dir: Path | None = None
        self._stats_lock = threading.Lock()
        self.tier_stats = {
            "evictions": 0, "evictions_s": 0.0, "spills": 0, "spills_s": 0.0,
            "unspills": 0, "unspills_s": 0.0, "stage_ins": 0, "stage_ins_s": 0.0,
            "sidecar_reuses": 0}
        self.last_build_stats: dict | None = None

    # --- configuration (ggnn.cuh:66-123) ----------------------------------

    def set_base(self, base) -> None:
        """The base (numpy, torch or :class:`Dataset`; [N, D] float32 or
        uint8). It stays where it lies; each shard moves to the device."""
        base = _as_tensor(base)
        if base.dim() != 2:
            raise ValueError("base must be [N, D]")
        if base.dtype not in (torch.float32, torch.uint8):
            raise ValueError(f"unsupported base dtype {base.dtype}")
        self._base = base
        self._shards = []
        self._cfg = None

    # the reference's name for the same call: the base is not copied either way
    set_base_reference = set_base

    def set_working_directory(self, path) -> None:
        self._working_dir = Path(path)

    def set_shard_size(self, n_shard: int) -> None:
        self._n_shard = int(n_shard)
        self._shards = []

    @property
    def device(self) -> torch.device:
        """The first slot's device: merged results land there."""
        return self._devices[0]

    @property
    def devices(self) -> list[torch.device]:
        """The device of each slot."""
        return list(self._devices)

    def set_devices(self, devices) -> None:
        """One slot per entry; the shards go to the slots in contiguous
        blocks. An entry may repeat a device: each slot then builds on its
        own worker and holds its own shards."""
        devices = [_device(d) for d in devices]
        if not devices:
            raise ValueError("set_devices needs at least one device")
        self._devices = devices
        self._shards = []

    def set_gpus(self, ids) -> None:
        """Reference-compatible alias: one slot per CUDA device index."""
        self.set_devices([torch.device("cuda", int(i)) for i in ids])

    def set_device_merge(self, enabled: bool = True) -> None:
        """With several slots that each hold one resident shard, walk every
        shard on its own device, one thread per device, and merge the
        partials on the first slot's device (on by default); off, they take
        the per-shard sweep and the host merge. The ids are the same."""
        self._device_merge = bool(enabled)

    # the JAX package's name for the same switch
    set_ici_merge = set_device_merge

    def set_cpu_memory_limit(self, limit: int) -> None:
        """Bound the host RAM of evicted shards' graph caches; beyond it an
        evicted shard spills to ``part_<id>.npz`` files."""
        self._cpu_memory_limit = int(limit)

    def set_reserved_gpu_memory(self, reserved: int) -> None:
        self._reserved_device_memory = int(reserved)

    def set_max_device_shards(self, n: int | None) -> None:
        """Cap the number of shards resident on the device at once."""
        self._max_device_shards = n

    def set_return_results_on_device(self, flag: bool = True) -> None:
        self._return_results_on_device = bool(flag)

    set_return_results_on_gpu = set_return_results_on_device

    # --- shard planning (ggnn.cu:154-203) ----------------------------------

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    def _prepare(self, k_build: int) -> None:
        if self._base is None:
            raise RuntimeError("no base data set -- call set_base() first")
        N, D = self._base.shape
        num_slots = len(self._devices)
        n_shard = self._n_shard
        if n_shard == 0:
            if N % num_slots:
                raise ValueError(
                    f"N={N} must be divisible by the number of devices "
                    f"{num_slots} (or set an explicit shard size)")
            n_shard = N // num_slots
        if N % n_shard:
            raise ValueError(f"N={N} not divisible by shard size {n_shard}")
        num_shards = N // n_shard
        if num_shards % num_slots:
            raise ValueError(f"number of shards {num_shards} not divisible by "
                             f"number of devices {num_slots}")
        self._cfg = GraphConfig.create(N=n_shard, D=D, KBuild=k_build)
        vlog(1, "%s", self._cfg.describe())
        # contiguous blocks of shards per slot (ggnn.cu's partitioning)
        per_slot = num_shards // num_slots
        self._shards = [
            _Shard(i, i // per_slot, self._devices[i // per_slot],
                   self._base[i * n_shard : (i + 1) * n_shard])
            for i in range(num_shards)
        ]

    def _resident_budget(self, fused: bool = False) -> int:
        """Shards allowed on the devices at once: the explicit cap, else,
        for each device, its memory less the reserve over twice a shard's
        base + graph (the reference's capacity planning from
        cudaMemGetInfo, gpu_instance.cu:136-227), and its fused index where
        the caller needs one (``fused``; u8 codes, ids and norms inline per
        neighbour), at least one per slot. Everything is resident on the
        CPU."""
        if self._max_device_shards is not None:
            return self._max_device_shards
        num_shards = len(self._shards)
        slots = Counter(self._devices)
        if (self._cfg is None or num_shards <= len(self._devices)
                or any(d.type != "cuda" for d in slots)):
            return num_shards
        cfg = self._cfg
        per_shard = (cfg.N * cfg.D * self._base.element_size() + cfg.N * 4
                     + cfg.graph_size_bytes())
        if fused:
            per_shard += cfg.N * cfg.KBuild * (cfg.D + 8)
        budget = 0
        for dev, n_slots in slots.items():
            _, total = torch.cuda.mem_get_info(dev)
            usable = max(0, total - self._reserved_device_memory)
            # 2x headroom for the walk's scratch
            budget += max(n_slots, usable // (2 * per_shard))
        return min(num_shards, budget)

    def _count(self, key: str, seconds: float | None = None) -> None:
        with self._stats_lock:
            self.tier_stats[key] += 1
            if seconds is not None:
                self.tier_stats[key + "_s"] += seconds

    # --- build / store / load (ggnn.cu:205-276) -----------------------------

    def build(
        self,
        k_build: int,
        tau_build: float,
        refinement_iterations: int = 2,
        measure: DistanceMeasure = DistanceMeasure.Euclidean,
        *,
        quantized_fetch: bool = True,
        sym_mode: str = "bulk",
        dense_seed_merge: bool = True,
    ) -> None:
        """Build the search graph of every shard (ggnn.cuh:130-133), shard
        ``i`` from seed ``1234 + i``, one worker thread per slot; with more
        shards than the devices hold each is evicted once built.

        ``quantized_fetch``: merges walk their layers through the quantized
        adjacency (off by itself above the 6 GiB inline bound, or when the
        u8 metric is unusable on this data: exact f32 fetches then).
        ``sym_mode``: "bulk" (default), "hybrid" or "walk"
        (``build/sym.py``). ``dense_seed_merge``: seed merges from a dense
        scan of the next layer's representatives; False runs the
        reference's hierarchic descent."""
        self._measure = DistanceMeasure(measure)
        self._prepare(k_build)
        budget = self._resident_budget()
        t0 = time.perf_counter()

        def build_slot(shards):
            stats = []
            for shard in shards:
                t_start = time.perf_counter()
                shard.ensure_base()
                graph, s = build_graph(
                    shard.base_dev, self._cfg, tau_build,
                    refinement_iterations, self._measure,
                    seed=self._build_seed + shard.shard_id,
                    quantized_fetch=quantized_fetch, sym_mode=sym_mode,
                    dense_seed_merge=dense_seed_merge,
                )
                shard.graph = graph
                shard.quantizer = s.pop("quantizer")
                s["wall_interval"] = (t_start, time.perf_counter())
                stats.append(s)
                if len(self._shards) > budget:
                    self._evict_shard(shard)
                vlog(0, "shard %d built in %.3f s (%.2f us/point)",
                     shard.shard_id, s["build_time_s"],
                     s["build_time_s"] * 1e6 / self._cfg.N)
            return stats

        by_slot: dict[int, list[_Shard]] = {}
        for shard in self._shards:
            by_slot.setdefault(shard.slot, []).append(shard)
        if len(by_slot) == 1:
            stats = build_slot(self._shards)
        else:
            # slots hold contiguous blocks: the workers' stats come back in
            # shard order
            per_slot = run_on_devices(
                [lambda b=b: build_slot(b) for b in by_slot.values()],
                [b[0].device for b in by_slot.values()])
            stats = [s for slot_stats in per_slot for s in slot_stats]
        wall = time.perf_counter() - t0
        self.last_build_stats = {
            "shards": stats,
            "wall_time_s": wall,
            "sum_time_s": sum(s["build_time_s"] for s in stats),
            "num_build_workers": len(by_slot),
        }
        vlog(0, "build completed in %.3f s (wall)", wall)

    def build_fused_index(self, group: int = 1, bits: int = 8) -> None:
        """Derive every shard's quantized-adjacency query layout
        (query/fused.py): each point's neighbours' quantized vectors stored
        inline, one contiguous fetch per expanded anchor. ``group=2`` pairs
        graph-nearest nodes so that one fetch serves both; ``bits=4`` packs
        int4 codes (half the block bytes). A loaded sidecar of the same
        group and bits is reused (no matching on the host). Enables
        ``query(engine="fused")``."""
        if not self.has_graph():
            raise RuntimeError("no graph -- call build() or load() first")
        budget = self._resident_budget(fused=True)
        for shard in self._shards:
            self._stage_in(shard)
            # the index is replaced: the shard's buffers are no longer the
            # tensors it walks, and go with them
            shard.buffers = None
            cached = shard.fused_index_host
            # validate against a host graph copy only: fingerprinting a
            # device graph would copy its layer 0 to the host just for that
            graph_h = shard.graph_host
            if (cached is not None and graph_h is not None
                    and cached.members.shape[1] == group
                    and int(cached.bits[0]) == bits
                    and fused_index_matches_graph(cached, graph_h, self._cfg.KBuild)):
                shard.fused_index = None
                shard.ensure_fused_index()
                self._count("sidecar_reuses")
            else:
                shard.fused_index = build_fused_index(
                    shard.base_dev, shard.graph, self._cfg, group=group,
                    bits=bits, quantizer=shard.quantizer)
                shard.fused_index_host = None  # stale meta (other layout)
            if len(self._shards) > budget:
                self._evict_shard(shard)

    def has_graph(self) -> bool:
        return bool(self._shards) and all(
            s.graph is not None or s.graph_host is not None or s.spilled
            for s in self._shards)

    def has_fused_index(self) -> bool:
        return bool(self._shards) and all(s.has_fused_index for s in self._shards)

    def get_graph(self, global_shard_id: int = 0) -> Graph:
        shard = self._shards[global_shard_id]
        shard.wait()
        if shard.graph is None and shard.graph_host is None and shard.spilled:
            self._unspill_shard(shard)
        graph = shard.graph if shard.graph is not None else shard.graph_host
        if graph is None:
            raise IndexError(f"no graph for shard {global_shard_id}")
        return graph

    def _io_pool(self) -> ThreadPoolExecutor:
        """Disk-I/O thread pool (the reference's per-slot io threads,
        gpu_instance.cuh:153-154)."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 4), thread_name_prefix="ggnn-io")
        return self._pool

    def close(self) -> None:
        """Finish in-flight disk I/O, stop the I/O threads and remove the
        temporary spill directory (used when no working directory is set);
        the instance is not used afterwards."""
        self._free_buffers.clear()
        for shard in self._shards:
            shard.wait()
            # free the walks' graph pools now, not with the tensors
            graphs.drop(shard.base_dev, shard.base_sq, *(shard.fused_index or ()),
                        *(shard.graph.neighbors if shard.graph is not None else ()))
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._tmp_spill_dir is not None:
            shutil.rmtree(self._tmp_spill_dir, ignore_errors=True)
            self._tmp_spill_dir = None

    # --- out-of-core tiers: device <-> host RAM <-> disk -------------------
    # (swapOutPart/swapInPart, gpu_instance.cu:371-467)

    def _spill_dir(self) -> Path:
        if self._working_dir is not None:
            return self._working_dir
        if self._tmp_spill_dir is None:
            self._tmp_spill_dir = Path(tempfile.mkdtemp(prefix="ggnn_spill_"))
        return self._tmp_spill_dir

    def _spill_shard(self, shard: _Shard) -> None:
        """Write an evicted shard's host cache to part files and free it
        (the disk tier; swapOutPart's force_to_file path). Runs on the I/O
        pool: host arrays only."""
        t0 = time.perf_counter()
        d = self._spill_dir()
        save_graph_shard(d / f"part_{shard.shard_id}.npz", shard.graph_host, self._cfg)
        fpath = d / f"part_{shard.shard_id}.fused.npz"
        meta = shard.fused_index_host
        if meta is not None:
            save_fused_index(fpath, meta)
        else:
            # no sidecar of another graph may come back at read-back
            fpath.unlink(missing_ok=True)
        # flags first: a reader never sees a shard with neither copy
        shard.spill_dir = d
        shard.spilled_fused = meta is not None
        shard.spilled = True
        shard.graph_host = None
        shard.fused_index_host = None
        self._count("spills", time.perf_counter() - t0)
        vlog(1, "shard %d spilled to %s", shard.shard_id, d)

    def _unspill_shard(self, shard: _Shard) -> None:
        """Read a spilled shard's host cache back from its part files."""
        t0 = time.perf_counter()
        d = shard.spill_dir
        shard.graph_host, _ = load_graph_shard(d / f"part_{shard.shard_id}.npz")
        if shard.spilled_fused:
            shard.fused_index_host = load_fused_index(
                d / f"part_{shard.shard_id}.fused.npz")
        shard.spilled = False
        self._count("unspills", time.perf_counter() - t0)

    def _evict_shard(self, shard: _Shard) -> None:
        """Device -> host RAM on this thread; beyond the CPU memory limit
        the host copy then spills to disk on the I/O pool."""
        t0 = time.perf_counter()
        buffers = shard.evict()
        if buffers is not None:
            self._free_buffers.append(buffers)
        self._count("evictions", time.perf_counter() - t0)
        if self._cpu_memory_limit is not None:
            total = sum(s.host_cache_bytes() for s in self._shards)
            if total > self._cpu_memory_limit:
                shard._pending = self._io_pool().submit(self._spill_shard, shard)

    def _stage_in(self, shard: _Shard, engine: str | None = None,
                  rotating: bool = False) -> None:
        """Make a shard device-resident: disk -> host RAM if spilled, then
        host -> device (swapInPart); the fused engine also needs its index
        re-assembled from the meta. Shards that rotate through the devices
        take buffers (:meth:`_to_buffers`). Synchronises the shard's device
        before and after, so that ``stage_ins_s`` times the stage-in
        alone."""
        shard.wait()
        if not (shard.graph is None or shard.base_dev is None
                or (engine == "fused" and shard.fused_index is None)):
            return
        graphs.synchronize(shard.device)
        t0 = time.perf_counter()
        if shard.graph is None and shard.graph_host is None and shard.spilled:
            self._unspill_shard(shard)
        shard.ensure_base()
        shard.ensure_graph()
        if engine == "fused":
            shard.ensure_fused_index()
        if rotating:
            self._to_buffers(shard)
        graphs.synchronize(shard.device)
        self._count("stage_ins", time.perf_counter() - t0)

    def _to_buffers(self, shard: _Shard) -> None:
        """Move a staged shard's walked tensors into the buffers an evicted
        shard left with the same shapes, or into new ones. The walks'
        captured graphs, keyed on the buffers' addresses, then serve every
        shard that rotates through them instead of being captured again per
        stage-in."""
        walked = shard.walked()
        sig = _signature(walked)
        i = next((i for i, b in enumerate(self._free_buffers)
                  if _signature(b) == sig), None)
        if i is not None:
            buffers = self._free_buffers.pop(i)
        else:
            buffers = {k: torch.empty_like(t) for k, t in walked.items()}
        old = shard.buffers
        shard.occupy(buffers)
        if old is not None and old is not buffers:
            self._free_buffers.append(old)

    def store(self) -> None:
        """Write every shard as ``part_<i>.npz`` in the working directory
        (the format both packages read), with its fused index's meta as
        ``part_<i>.fused.npz``; a sidecar left from an earlier index is
        deleted."""
        if self._working_dir is None:
            raise RuntimeError("set_working_directory() first")
        jobs = []
        for shard in self._shards:
            shard.wait()
            if shard.graph is None and shard.graph_host is None and shard.spilled:
                self._unspill_shard(shard)
            graph = shard.graph_host
            if graph is None:
                if shard.graph is None:
                    raise RuntimeError(f"shard {shard.shard_id}: nothing to store")
                graph = shard.graph.to("cpu")
            fused = (shard.fused_index if shard.fused_index is not None
                     else shard.fused_index_host)
            jobs.append((shard.shard_id, graph,
                         None if fused is None else meta_of(fused, graph)))

        def store_one(job):
            i, graph, meta = job
            save_graph_shard(self._working_dir / f"part_{i}.npz", graph, self._cfg)
            fpath = self._working_dir / f"part_{i}.fused.npz"
            if meta is not None:
                save_fused_index(fpath, meta)
            else:
                # a rebuilt graph stored without its derived index must not
                # leave an old adjacency's sidecar on disk
                fpath.unlink(missing_ok=True)

        list(self._io_pool().map(store_one, jobs))

    def load(self, k_build: int) -> None:
        """Read every ``part_<i>.npz`` of the working directory into host
        RAM (shards stage in at first use), with each fused sidecar that
        matches its graph; a stale one is ignored."""
        if self._working_dir is None:
            raise RuntimeError("set_working_directory() first")
        self._prepare(k_build)

        def load_one(shard):
            path = self._working_dir / f"part_{shard.shard_id}.npz"
            graph, cfg = load_graph_shard(path)
            if cfg.N != self._cfg.N or cfg.KBuild != k_build or cfg.D != self._cfg.D:
                raise ValueError(f"{path}: incompatible graph geometry")
            shard.graph_host = graph
            fpath = self._working_dir / f"part_{shard.shard_id}.fused.npz"
            if not fpath.exists():
                return
            try:
                fused = load_fused_index(fpath)
                ok = fused_index_matches_graph(fused, graph, k_build)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile):
                ok = False  # an unreadable sidecar
            if ok:
                shard.fused_index_host = fused
            else:
                vlog(0, "shard %d: stale fused index sidecar %s ignored "
                     "(adjacency does not match the loaded graph)",
                     shard.shard_id, fpath)

        list(self._io_pool().map(load_one, self._shards))

    # --- query (ggnn.cu:278-390) -------------------------------------------

    def _engine_kwargs(self, engine: str, engine_kwargs: dict) -> dict:
        if engine not in ("row", "fused"):
            raise ValueError(f"unknown engine {engine!r}")
        kw = {}
        for name, value in engine_kwargs.items():
            if name not in self._ENGINE_KWARGS:
                raise TypeError(f"query() got an unexpected keyword {name!r}")
            engines, _ = self._ENGINE_KWARGS[name]
            if engine not in engines:
                raise ValueError(
                    f"query(engine={engine!r}) does not accept {name!r} "
                    f"(applies to {'/'.join(engines)})"
                )
            kw[name] = value
        for name, (engines, default) in self._ENGINE_KWARGS.items():
            if engine in engines:
                kw.setdefault(name, default)
        return kw

    def _query_partials(self, query, k_query, tau_query, max_iterations,
                        measure, engine, engine_kwargs):
        """Each shard's (ids with global offsets, dists), rotating shards
        through their devices when they do not all fit; or, on the device
        merge route, one entry already merged across the slots."""
        if not self.has_graph():
            raise RuntimeError("no graph -- call build() or load() first")
        if k_query > MAX_KQUERY:
            raise ValueError(f"k_query={k_query} exceeds {MAX_KQUERY}")
        kw = self._engine_kwargs(engine, engine_kwargs)
        if engine == "fused" and not self.has_fused_index():
            raise RuntimeError("no fused index -- call build_fused_index() first")
        measure = DistanceMeasure(measure) if measure is not None else self._measure
        query = _as_tensor(query)
        merged = self._query_across_devices(query, k_query, tau_query,
                                            max_iterations, measure, engine, kw)
        if merged is not None:
            return [merged]
        queries = per_device(query, [s.device for s in self._shards])
        n_shard = self._cfg.N
        budget = max(1, self._resident_budget(fused=engine == "fused"))
        resident = sum(1 for s in self._shards if s.resident)
        # alternate the sweep direction per call so that the shards the
        # previous call left resident go first (process_shards_back_to_front,
        # gpu_instance.cu:580,605,740)
        order = list(self._shards)
        if self._back_to_front and len(order) > budget:
            order.reverse()
        self._back_to_front = not self._back_to_front

        partials = []
        for i, shard in enumerate(order):
            shard.wait()
            if not shard.resident:
                while resident >= budget:
                    # a shard on the same device first: that frees its memory
                    victim = min((s for s in self._shards
                                  if s.resident and s is not shard),
                                 key=lambda s: s.device != shard.device,
                                 default=None)
                    if victim is None:
                        break
                    self._evict_shard(victim)
                    resident -= 1
                resident += 1
            self._stage_in(shard, engine, rotating=len(order) > budget)
            q = queries[shard.device]
            if engine == "fused":
                ids, dists = fused_query(
                    q, shard.ensure_fused_index(), shard.base_dev, k_query,
                    tau_query, max_iterations, measure, base_sq=shard.base_sq,
                    chunk=kw["chunk"], pops_per_iter=kw["pops_per_iter"],
                    num_seeds=kw["num_seeds"], rerank=kw["rerank"], cap=kw["cap"],
                    compact_levels=kw["compact_levels"], width=kw["width"],
                    seed_approx=kw["seed_approx"],
                )
            else:
                ids, dists = ann_query(
                    q, shard.base_dev, shard.graph, self._cfg, k_query,
                    tau_query, max_iterations, measure, base_sq=shard.base_sq,
                    pops_per_iter=kw["pops_per_iter"],
                    fetch_cap_fraction=kw["fetch_cap_fraction"],
                )
            if shard.shard_id:
                # global ids (query_layer.cu:81-90 writes shard offsets)
                ids = torch.where(ids >= 0, ids + shard.shard_id * n_shard, ids)
            partials.append((shard.shard_id, ids, dists))
            # overlap: read the next spilled shard back from disk while this
            # shard's results are still being computed
            if i + 1 < len(order):
                nxt = order[i + 1]
                if nxt.spilled and nxt._pending is None:
                    nxt._pending = self._io_pool().submit(self._unspill_shard, nxt)
        self._free_buffers.clear()
        # merge in shard order whichever way the sweep went, so that ties
        # break alike in rotated and resident runs
        return [(ids, dists) for _, ids, dists in sorted(partials,
                                                          key=lambda p: p[0])]

    def _one_shard_per_slot(self) -> bool:
        """The layout of the device merge route: several slots, each holding
        exactly one shard (the switch on)."""
        return (self._device_merge and len(self._devices) > 1
                and len(self._shards) == len(self._devices))

    def _query_across_devices(self, query, k_query, tau_query, max_iterations,
                              measure, engine, kw):
        """The device merge route (the JAX package's ``_try_ici_query``):
        when every slot holds exactly one resident shard, each walks on its
        own device (one thread per device) with every engine kwarg, and the
        partials merge on the first slot's device. Returns the merged
        (ids, dists), or None for the per-shard sweep and the host merge."""
        if not self._one_shard_per_slot():
            return None
        shards = self._shards
        for s in shards:
            s.wait()
            if not s.resident or s.base_dev is None:
                return None  # out of core: the rotation takes it
        common = dict(base_sqs=[s.base_sq for s in shards],
                      pops_per_iter=kw["pops_per_iter"], device=self.device)
        bases = [s.base_dev for s in shards]
        if engine == "fused":
            return sharded_fused_query(
                bases, [s.ensure_fused_index() for s in shards], query,
                k_query, tau_query, max_iterations, measure,
                num_seeds=kw["num_seeds"], rerank=kw["rerank"], cap=kw["cap"],
                width=kw["width"], chunk=kw["chunk"],
                compact_levels=kw["compact_levels"],
                seed_approx=kw["seed_approx"], **common)
        return sharded_query(
            bases, [s.graph for s in shards], self._cfg, query, k_query,
            tau_query, max_iterations, measure,
            fetch_cap_fraction=kw["fetch_cap_fraction"], **common)

    def query(self, query, k_query: int, tau_query: float,
              max_iterations: int = 400, measure: DistanceMeasure | None = None,
              *, engine: str = "row", **engine_kwargs) -> Results:
        """k-NN of each query row over all shards. ``engine="row"`` walks
        the point graph gathering f32 rows (reference semantics, exact
        distances); ``engine="fused"`` walks the same graph through the
        quantized-adjacency layout (build_fused_index() first).

        Engine kwargs: ``pops_per_iter`` (row/fused), ``fetch_cap_fraction``
        (row), ``num_seeds``, ``rerank``, ``cap``, ``chunk``,
        ``compact_levels``, ``width``, ``seed_approx`` (fused).

        The call is the span ``ggnn.query``; its results' way to the host is
        ``ggnn.to_host`` (``utils/spans.py``)."""
        with span("ggnn.query"):
            partials = self._query_partials(query, k_query, tau_query,
                                            max_iterations, measure, engine,
                                            engine_kwargs)
            return self._merge_results(partials, k_query)

    def query_async(self, query, k_query: int, tau_query: float,
                    max_iterations: int = 400,
                    measure: DistanceMeasure | None = None, *,
                    engine: str = "row", **engine_kwargs) -> ResultsFuture:
        """Queue a query batch (either engine); the host copy of its results
        waits until ``.result()`` is called, and a host merge runs on the
        I/O pool meanwhile. The submit is the span ``ggnn.query``."""
        with span("ggnn.query"):
            partials = self._query_partials(query, k_query, tau_query,
                                            max_iterations, measure, engine,
                                            engine_kwargs)
            if self._on_host(partials):
                fut = self._io_pool().submit(
                    lambda: self._finalize_host(
                        *self._merge_on_host(partials, k_query)))

                def wait():
                    with span("ggnn.to_host"):
                        return fut.result()

                return ResultsFuture(wait)
            ids, dists = self._merge_on_device(partials, k_query)
            return ResultsFuture(lambda: self._finalize(ids, dists))

    def bf_query(self, query, k_gt: int = 100,
                 measure: DistanceMeasure | None = None) -> Results:
        """Brute-force ground truth over all shards (ggnn.cu:332-390); with
        one shard per slot each scans on its own device and the results
        merge on the first slot's device."""
        if self._base is None:
            raise RuntimeError("no base data set")
        measure = DistanceMeasure(measure) if measure is not None else self._measure
        query = _as_tensor(query)
        if not self._shards:
            # not prepared: one scan over the whole base
            ids, dists = bruteforce_knn(self._base.to(self.device),
                                        query.to(self.device), k_gt, measure)
            return self._finalize(ids, dists)

        def base_of(shard):
            # a shard that is not resident lends its base for this scan only
            shard.wait()
            if shard.base_dev is not None:
                return shard.base_dev
            return shard.base_host.to(shard.device)

        if self._one_shard_per_slot():
            merged = sharded_bf_query([base_of(s) for s in self._shards], query,
                                      k_gt, measure, device=self.device)
            return self._merge_results([merged], k_gt)
        queries = per_device(query, [s.device for s in self._shards])
        n_shard = self._cfg.N
        partials = []
        for shard in self._shards:
            ids, dists = bruteforce_knn(base_of(shard), queries[shard.device],
                                        min(k_gt, n_shard), measure)
            if shard.shard_id:
                ids = torch.where(ids >= 0, ids + shard.shard_id * n_shard, ids)
            partials.append((ids, dists))
        return self._merge_results(partials, k_gt)

    # --- result merging (result_merger.cpp:52-148) --------------------------

    def _on_host(self, partials) -> bool:
        """Whether these partials merge on the host: several slots' shards,
        not merged across the devices already. Records the route."""
        if len(self._devices) == 1:
            self.last_merge_route = "device"
        else:
            self.last_merge_route = "devices" if len(partials) == 1 else "host"
        return self.last_merge_route == "host"

    def _merge_results(self, partials, k: int) -> Results:
        if self._on_host(partials):
            return self._finalize_host(*self._merge_on_host(partials, k))
        return self._finalize(*self._merge_on_device(partials, k))

    @staticmethod
    def _merge_on_device(partials, k: int):
        """Concatenate the shards' partials and keep the k smallest per row.
        The sort is stable, so among equal distances the earlier column --
        the lower shard, then the better rank -- goes first, as the
        reference's ``lax.top_k`` keeps it."""
        if len(partials) == 1:
            return partials[0]
        return merge_over_devices(partials, k)

    @staticmethod
    def _merge_on_host(partials, k: int):
        """The host merge of several slots' partials (the reference's
        ResultMerger): the native k-way merger when it is built, else -- and
        where it raises -- numpy's stable sort, with a warning. Both keep
        the device merge's tie order."""
        with span("ggnn.to_host"):
            ids = np.stack([p[0].cpu().numpy() for p in partials])
            dists = np.stack([p[1].cpu().numpy() for p in partials])
        if native_merge.available():
            try:
                return native_merge.merge_topk_partials(ids, dists, k)
            except Exception:
                logger.warning("native result merger failed; numpy merge instead",
                               exc_info=True)
        else:
            logger.warning("native result merger not built; numpy merge instead")
        ids = np.concatenate(list(ids), axis=1)
        dists = np.concatenate(list(dists), axis=1)
        order = np.argsort(dists, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(ids, order, axis=1),
                np.take_along_axis(dists, order, axis=1))

    def _finalize(self, ids, dists) -> Results:
        if self._return_results_on_device:
            return Results(ids, dists)
        with span("ggnn.to_host"):
            return Results(ids.cpu().numpy(), dists.cpu().numpy())

    def _finalize_host(self, ids: np.ndarray, dists: np.ndarray) -> Results:
        """Host-merged results, uploaded to the first slot's device when
        results on the device were asked for."""
        if self._return_results_on_device:
            return Results(torch.from_numpy(ids).to(self.device),
                           torch.from_numpy(dists).to(self.device))
        return Results(ids, dists)
