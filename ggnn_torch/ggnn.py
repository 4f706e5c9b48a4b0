"""Public GGNN API of the PyTorch port: one shard on one device.

Equivalent of the reference's ``GGNN`` facade + ``GPUInstance`` runtime
(src/ggnn/base/ggnn.cu:53-564, src/ggnn/base/gpu_instance.cu:136-790) for a
single shard: the base lives on the chosen device, the graph is built there,
the quantized-adjacency ("fused") index is derived from it, and queries walk
it. Several shards or devices, out-of-core rotation and the row engine are
not ported yet (ROADMAP Queue 1 items 7 and 8).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ggnn_torch.build.construction import build_graph
from ggnn_torch.config import MAX_KQUERY, DistanceMeasure, GraphConfig
from ggnn_torch.graph import Graph, load_graph_shard, save_graph_shard
from ggnn_torch.ops.bruteforce import bruteforce_knn
from ggnn_torch.ops.distance import squared_norms
from ggnn_torch.query.fused import FusedIndex, build_fused_index, fused_query
from ggnn_torch.utils.logging import vlog

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


def _as_tensor(data, device: torch.device) -> torch.Tensor:
    """A float32/uint8 tensor on ``device`` (float64 is downcast)."""
    t = data if isinstance(data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(data))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t.to(device).contiguous()


class GGNN:
    """Graph-based nearest-neighbor search on one device.

    Usage matches the reference Python bindings::

        g = GGNN(device="cuda")
        g.set_base(base)                       # np/torch [N, D] float32 or uint8
        g.build(k_build=24, tau_build=0.5)
        g.build_fused_index()
        ids, dists = g.query(queries, 10, tau_query=0.5, engine="fused")
        gt_ids, gt_dists = g.bf_query(queries, k_gt=100)

    ``device="cuda"`` needs a CUDA device and raises without one; it never
    carries on on the CPU.
    """

    # fused-engine query kwargs and their defaults (``seed_approx`` is
    # accepted for API parity: seeds are always exact top-k here)
    _ENGINE_KWARGS = {
        "pops_per_iter": 8,
        "num_seeds": 16,
        "rerank": None,
        "cap": None,
        "chunk": 8192,
        "compact_levels": 2,
        "seed_approx": True,
        "width": None,
    }

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GGNN(device='cuda'): no CUDA device is available")
        self._base: torch.Tensor | None = None
        self._base_sq: torch.Tensor | None = None
        self._cfg: GraphConfig | None = None
        self._graph: Graph | None = None
        self._index: FusedIndex | None = None
        self._quantizer = None  # (scale, zero) fitted by the last build
        self._measure = DistanceMeasure.Euclidean
        self._build_seed = 1234
        self._working_dir: Path | None = None
        self._return_results_on_device = False
        self.last_build_stats: dict | None = None

    # --- configuration (ggnn.cuh:66-123) ----------------------------------

    def set_base(self, base) -> None:
        base = _as_tensor(base, self.device)
        if base.dim() != 2:
            raise ValueError("base must be [N, D]")
        if base.dtype not in (torch.float32, torch.uint8):
            raise ValueError(f"unsupported base dtype {base.dtype}")
        self._base = base
        self._base_sq = squared_norms(base)
        self._cfg = None
        self._graph = None
        self._index = None
        self._quantizer = None

    def set_working_directory(self, path) -> None:
        self._working_dir = Path(path)

    def set_shard_size(self, n_shard: int) -> None:
        if self._base is None or int(n_shard) != self._base.shape[0]:
            raise NotImplementedError(
                "several shards are not ported yet (ROADMAP Queue 1 item 8)"
            )

    def set_return_results_on_device(self, flag: bool = True) -> None:
        self._return_results_on_device = bool(flag)

    def _prepare(self, k_build: int) -> None:
        if self._base is None:
            raise RuntimeError("no base data set -- call set_base() first")
        N, D = self._base.shape
        self._cfg = GraphConfig.create(N=N, D=D, KBuild=k_build)
        vlog(1, "%s", self._cfg.describe())

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
        """Build the search graph (ggnn.cuh:130-133) with the JAX package's
        default schedule: quantized layer walks, dense-seed merges and the
        bulk sym pass."""
        if not quantized_fetch:
            raise NotImplementedError(
                "quantized_fetch=False is not ported yet (ROADMAP Queue 1 item 9)"
            )
        if not dense_seed_merge:
            raise NotImplementedError(
                "the descent merge is not ported yet (ROADMAP Queue 1 item 9)"
            )
        if sym_mode != "bulk":
            raise NotImplementedError(
                f"sym_mode={sym_mode!r} is not ported yet (ROADMAP Queue 1 item 9)"
            )
        self._measure = DistanceMeasure(measure)
        self._prepare(k_build)
        self._index = None
        graph, stats = build_graph(
            self._base, self._cfg, tau_build, refinement_iterations,
            self._measure, seed=self._build_seed,
        )
        self._graph = graph
        self._quantizer = stats.pop("quantizer")
        self.last_build_stats = {"shards": [stats],
                                 "wall_time_s": stats["build_time_s"]}
        vlog(0, "build completed in %.3f s", stats["build_time_s"])

    def build_fused_index(self, group: int = 1, bits: int = 8) -> None:
        """Derive the quantized-adjacency query layout (query/fused.py):
        each point's neighbours' quantized vectors stored inline, one
        contiguous fetch per expanded anchor. Enables
        ``query(engine="fused")``."""
        if self._graph is None:
            raise RuntimeError("no graph -- call build() or load() first")
        self._index = build_fused_index(self._base, self._graph, self._cfg,
                                        group=group, bits=bits,
                                        quantizer=self._quantizer)

    def get_graph(self, global_shard_id: int = 0) -> Graph:
        if global_shard_id != 0 or self._graph is None:
            raise IndexError(f"no graph for shard {global_shard_id}")
        return self._graph

    def store(self) -> None:
        """Write the graph as ``part_0.npz`` in the working directory (the
        format both packages read)."""
        if self._working_dir is None:
            raise RuntimeError("set_working_directory() first")
        if self._graph is None:
            raise RuntimeError("shard 0: nothing to store")
        save_graph_shard(self._working_dir / "part_0.npz", self._graph, self._cfg)

    def load(self, k_build: int) -> None:
        """Read ``part_0.npz`` from the working directory onto the device."""
        if self._working_dir is None:
            raise RuntimeError("set_working_directory() first")
        self._prepare(k_build)
        path = self._working_dir / "part_0.npz"
        graph, cfg = load_graph_shard(path, device=self.device)
        if cfg.N != self._cfg.N or cfg.KBuild != k_build or cfg.D != self._cfg.D:
            raise ValueError(f"{path}: incompatible graph geometry")
        self._graph = graph
        self._index = None

    # --- query (ggnn.cu:278-390) -------------------------------------------

    def _engine_kwargs(self, engine: str, engine_kwargs: dict) -> dict:
        if engine == "row":
            raise NotImplementedError(
                "the row engine is not ported yet (ROADMAP Queue 1 item 7); "
                "use engine='fused'"
            )
        if engine != "fused":
            raise ValueError(f"unknown engine {engine!r}")
        kw = dict(self._ENGINE_KWARGS)
        for name, value in engine_kwargs.items():
            if name not in kw:
                raise TypeError(f"query() got an unexpected keyword {name!r}")
            kw[name] = value
        return kw

    def _run_query(self, query, k_query, tau_query, max_iterations, measure,
                   engine, engine_kwargs):
        if self._graph is None:
            raise RuntimeError("no graph -- call build() or load() first")
        if k_query > MAX_KQUERY:
            raise ValueError(f"k_query={k_query} exceeds {MAX_KQUERY}")
        kw = self._engine_kwargs(engine, engine_kwargs)
        if self._index is None:
            raise RuntimeError("no fused index -- call build_fused_index() first")
        measure = DistanceMeasure(measure) if measure is not None else self._measure
        return fused_query(
            _as_tensor(query, self.device), self._index, self._base, k_query,
            tau_query, max_iterations, measure, base_sq=self._base_sq,
            chunk=kw["chunk"], pops_per_iter=kw["pops_per_iter"],
            num_seeds=kw["num_seeds"], rerank=kw["rerank"], cap=kw["cap"],
            compact_levels=kw["compact_levels"], width=kw["width"],
        )

    def query(self, query, k_query: int, tau_query: float,
              max_iterations: int = 400, measure: DistanceMeasure | None = None,
              *, engine: str = "row", **engine_kwargs) -> Results:
        """k-NN of each query row: ``engine="fused"`` walks the graph through
        the quantized-adjacency layout (build_fused_index() first).

        Engine kwargs: ``pops_per_iter``, ``num_seeds``, ``rerank``, ``cap``,
        ``chunk``, ``compact_levels``, ``width``, ``seed_approx``."""
        ids, dists = self._run_query(query, k_query, tau_query, max_iterations,
                                     measure, engine, engine_kwargs)
        return self._finalize(ids, dists)

    def query_async(self, query, k_query: int, tau_query: float,
                    max_iterations: int = 400,
                    measure: DistanceMeasure | None = None, *,
                    engine: str = "row", **engine_kwargs) -> ResultsFuture:
        """Queue a query batch; the host copy of its results waits until
        ``.result()`` is called."""
        ids, dists = self._run_query(query, k_query, tau_query, max_iterations,
                                     measure, engine, engine_kwargs)
        return ResultsFuture(lambda: self._finalize(ids, dists))

    def bf_query(self, query, k_gt: int = 100,
                 measure: DistanceMeasure | None = None) -> Results:
        """Brute-force ground truth (ggnn.cu:332-390)."""
        if self._base is None:
            raise RuntimeError("no base data set")
        measure = DistanceMeasure(measure) if measure is not None else self._measure
        ids, dists = bruteforce_knn(self._base, _as_tensor(query, self.device),
                                    k_gt, measure)
        return self._finalize(ids, dists)

    def _finalize(self, ids, dists) -> Results:
        if self._return_results_on_device:
            return Results(ids, dists)
        return Results(ids.cpu().numpy(), dists.cpu().numpy())
