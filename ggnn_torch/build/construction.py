"""Graph construction schedule (build + refine).

Replacement for the reference ``GraphConstruction``
(src/ggnn/construction/graph_construction.cu:104-403). The layer schedule is
kept verbatim (graph_construction.cu:128-147):

    build():  for layer_top in 0..L-1:
                for layer_btm in layer_top..0 (descending):
                  merge(layer_top, layer_btm)        # top==btm -> top_merge
                  if layer_top < L-1 and top == btm: select(layer_top)
                  sym(layer_btm)

    refine(): for layer in L-2..0: merge(L-1, layer); sym(layer)

Randomness is one ``torch.Generator`` on the build device, seeded like
graph_construction.cu:100 for determinism.

Merges walk their layers through the quantized adjacency (query/fused.py
layout) unless ``quantized_fetch`` is off, the inline layer-0 adjacency
would exceed :data:`QUANTIZED_FETCH_MAX_BYTES`, or the u8 metric proves
unusable on the data (:meth:`_BuildContext._quant_usable`); then they walk
exact f32 rows, as the JAX package does.
"""

from __future__ import annotations

import torch

from ggnn_torch.build.merge import merge_layer
from ggnn_torch.build.select import wrs_select_layer
from ggnn_torch.build.sym import sym_pass
from ggnn_torch.build.top_merge import top_merge_layer
from ggnn_torch.config import DistanceMeasure, GraphConfig
from ggnn_torch.graph import Graph
from ggnn_torch.ops.distance import squared_norms
from ggnn_torch.query.fused import encode_u8, make_adjacency, quantizer_for
from ggnn_torch.utils.logging import vlog
from ggnn_torch.utils.timing import PhaseTimer

__all__ = ["build_graph", "QUANTIZED_FETCH_MAX_BYTES", "quantized_fetch_fits"]

# bound on the inline layer-0 adjacency (N * KBuild * D code bytes) above
# which the build walks exact f32 rows instead
QUANTIZED_FETCH_MAX_BYTES = 6 << 30


def quantized_fetch_fits(cfg: GraphConfig) -> bool:
    """Whether the quantized merge fetch is allowed for this geometry: its
    inline layer-0 adjacency must fit comfortably on the device."""
    return cfg.N * cfg.KBuild * cfg.D <= QUANTIZED_FETCH_MAX_BYTES


class _BuildContext:
    """Mutable per-shard construction state (the reference's GraphBuffer +
    Graph pair, graph_buffer.cuh:38-92)."""

    def __init__(self, base, cfg: GraphConfig, measure, tau_build, seed, chunk,
                 quantized_fetch=True, sym_mode="bulk", dense_seed_merge=True):
        dev = base.device
        self.cfg = cfg
        self.measure = DistanceMeasure(measure)
        self.tau_build = float(tau_build)
        self.base = base
        self.base_sq = squared_norms(base)
        self.chunk = chunk
        self.sym_mode = sym_mode
        self.dense_seed_merge = bool(dense_seed_merge)
        self.quantized_fetch = bool(quantized_fetch) and quantized_fetch_fits(cfg)
        if quantized_fetch and not self.quantized_fetch:
            vlog(0, "quantized fetch disabled: the inline adjacency would "
                 "take %d bytes (> %d) -- building with exact f32 fetches",
                 cfg.N * cfg.KBuild * cfg.D, QUANTIZED_FETCH_MAX_BYTES)
        self.timer = PhaseTimer(dev)
        self._codes = None  # fitted on first use by a quantized walk
        self._quant_ok = None
        L = cfg.L
        self.neighbors = [
            torch.full((cfg.Ns[l], cfg.KBuild), -1, dtype=torch.int32, device=dev)
            for l in range(L)
        ]
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        self.selection = [empty] * L
        self.translation = [empty] * L
        self.nn1_dist = [None] * L  # per-layer 1-NN distance buffers
        self.nn1_stats = torch.zeros((2,), dtype=torch.float32, device=dev)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.sym_stats = []

    def _ensure_codes(self):
        """Fit the u8 quantizer and encode the base (once, on first use)."""
        if self._codes is None:
            with self.timer.phase("quantize", self.cfg.N):
                self._scale, self._zero = quantizer_for(self.base)
                self._codes, self._x_hat_sq = encode_u8(
                    self.base.to(torch.float32), self._scale, self._zero
                )

    def _layer_adjacency(self, layer: int):
        """Inline one layer's current neighbourhoods as quantized code blocks
        (rebuilt per merge pass -- the read-side graph changes). Upper-layer
        tables address the layer-local id space; their codes come from the
        translated base vectors."""
        if layer == 0:
            codes, sq = self._codes, self._x_hat_sq
        else:
            tr = self.translation[layer].long()
            codes, sq = self._codes[tr], self._x_hat_sq[tr]
        return make_adjacency(codes, sq, self.neighbors[layer], self._scale,
                              self._zero)

    def _quant_usable(self) -> bool:
        """Whether the u8 walk metric is sane for this data.

        One heavy-tailed dimension can inflate the quantization step until
        walk distances are noise: if the mean dequantization error is
        comparable to the mean 1-NN distance, the build falls back to the
        exact f32 fetch (and says so). Euclidean only -- nn1_stats are
        cosine distances under Cosine, where no comparable scale exists;
        uint8 input is exact by construction."""
        if self._quant_ok is None:
            if self.measure != DistanceMeasure.Euclidean:
                self._quant_ok = True
            else:
                self._ensure_codes()
                sample = min(4096, self.cfg.N)
                x = self.base[:sample].to(torch.float32)
                x_hat = (self._codes[:sample].to(torch.float32) * self._scale
                         + self._zero)
                err = float(torch.mean(torch.linalg.norm(x - x_hat, dim=-1)))
                nn1_mean = float(self.nn1_stats[0])
                self._quant_ok = nn1_mean <= 0.0 or err < 0.5 * nn1_mean
                if not self._quant_ok:
                    vlog(0, "quantized fetch disabled: mean dequantization "
                         "error %.3g vs mean 1-NN distance %.3g -- building "
                         "with exact f32 fetches instead", err, nn1_mean)
        return self._quant_ok

    # --- schedule steps ---------------------------------------------------

    def merge(self, layer_top: int, layer_btm: int):
        if layer_top == layer_btm:
            self.top(layer_btm)
        else:
            self.merge_descend(layer_top, layer_btm)
        if layer_btm == 0:
            self.compute_nn1_stats()

    def top(self, layer: int):
        with self.timer.phase(f"top[{layer}]", self.cfg.Ns[layer]):
            nbrs, nn1 = top_merge_layer(
                self.base, self.base_sq,
                self.translation[layer] if layer else None,
                self.cfg, layer, self.measure,
            )
            self.neighbors[layer] = nbrs
            self.nn1_dist[layer] = nn1

    def merge_descend(self, layer_top: int, layer_btm: int):
        adjs = None
        if self.quantized_fetch and self._quant_usable():
            # every layer the descent walks (layer_top-1 .. layer_btm) gets an
            # inline-code adjacency; dense seeding walks only layer_btm
            self._ensure_codes()
            with self.timer.phase(f"adj[{layer_top}->{layer_btm}]",
                                  self.cfg.Ns[layer_btm]):
                adjs = tuple(
                    self._layer_adjacency(l)
                    if (l == layer_btm if self.dense_seed_merge
                        else layer_btm <= l < layer_top)
                    else None
                    for l in range(self.cfg.L)
                )
        else:
            self.quantized_fetch = False  # don't re-check every pass
        with self.timer.phase(f"merge[{layer_top}->{layer_btm}]",
                              self.cfg.Ns[layer_btm]):
            nbrs, nn1 = merge_layer(
                self.base, self.base_sq, tuple(self.neighbors),
                tuple(self.selection), tuple(self.translation), self.nn1_stats,
                self.cfg, layer_top, layer_btm, self.measure, self.tau_build,
                chunk=self.chunk, adjs=adjs, dense_seed=self.dense_seed_merge,
            )
            self.neighbors[layer_btm] = nbrs
            if layer_btm == 0:
                self.nn1_dist[0] = nn1

    def select(self, layer: int):
        with self.timer.phase(f"select[{layer}]", self.cfg.Bs[layer]):
            sel, trans = wrs_select_layer(
                self.generator, self.nn1_dist[layer],
                self.translation[layer] if layer else None, self.cfg, layer,
            )
            self.selection[layer + 1] = sel
            self.translation[layer + 1] = trans

    def sym(self, layer: int):
        with self.timer.phase(f"sym[{layer}]", self.cfg.Ns[layer]):
            nbrs, stats = sym_pass(
                self.base, self.base_sq, self.neighbors[layer],
                self.translation[layer] if layer else None, self.nn1_stats,
                self.cfg, layer, self.measure, self.tau_build,
                mode=self.sym_mode,
            )
            self.neighbors[layer] = nbrs
            self.sym_stats.append({"layer": layer, **stats})
            vlog(
                2,
                "Layer %d [N: %d] | overflow: %d (%.4f) | added_links: %d (%.4f)",
                layer, stats["N"], stats["overflow"],
                stats["overflow"] / stats["N"], stats["added_links"],
                stats["added_links"] / stats["N"],
            )

    def compute_nn1_stats(self):
        # graph_construction.cu:381-402: mean and max of layer-0 1-NN dists
        nn1 = self.nn1_dist[0]
        self.nn1_stats = torch.stack([torch.mean(nn1), torch.max(nn1)]).to(
            torch.float32
        )
        vlog(2, "nn1 stats -- mean: %s | max: %s", *self.nn1_stats.tolist())

    def to_graph(self) -> Graph:
        return Graph(
            neighbors=tuple(self.neighbors),
            selection=tuple(self.selection),
            translation=tuple(self.translation),
            nn1_stats=self.nn1_stats,
        )


@torch.no_grad()
def build_graph(
    base: torch.Tensor,
    cfg: GraphConfig,
    tau_build: float,
    refinement_iterations: int = 2,
    measure: DistanceMeasure = DistanceMeasure.Euclidean,
    seed: int = 1234,
    chunk: int = 8192,
    quantized_fetch: bool = True,
    sym_mode: str = "bulk",
    dense_seed_merge: bool = True,
) -> tuple[Graph, dict]:
    """Build one graph shard on ``base``'s device. Returns (graph, build
    stats with per-phase seconds and the ``quantizer`` (scale, zero) fitted
    on the base, or None when no quantized walk needed one).

    ``sym_mode``: "bulk" (drop residual links instead of walking; default),
    "hybrid" (bulk proposals + residual walks), "walk" (walk every
    unconnected pair -- the reference's shape). ``dense_seed_merge``: seed
    merge beams from a dense scan of the next layer's representatives
    instead of the reference's hierarchic descent (merge_layer.cu:86-121).
    """
    ctx = _BuildContext(base, cfg, measure, tau_build, seed, chunk,
                        quantized_fetch=quantized_fetch, sym_mode=sym_mode,
                        dense_seed_merge=dense_seed_merge)
    L = cfg.L
    # graph_construction.cu:128-140
    for layer_top in range(L):
        for layer_btm in range(layer_top, -1, -1):
            ctx.merge(layer_top, layer_btm)
            if layer_top < L - 1 and layer_top == layer_btm:
                ctx.select(layer_top)
            ctx.sym(layer_btm)
    # refinement (gpu_instance.cu:552-555)
    for _ in range(refinement_iterations):
        for layer in range(L - 2, -1, -1):
            ctx.merge(L - 1, layer)
            ctx.sym(layer)
    stats = {
        "phases": dict(ctx.timer.phases),
        "sym": ctx.sym_stats,
        "build_time_s": ctx.timer.total(),
        "quantizer": None if ctx._codes is None else (ctx._scale, ctx._zero),
    }
    return ctx.to_graph(), stats
