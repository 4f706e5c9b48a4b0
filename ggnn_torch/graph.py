"""The hierarchical search-graph container.

Equivalent of the reference's ``Graph`` (include/ggnn/base/graph.h:38-76):
where the reference carves one flat byte pool into per-layer views, we keep
per-layer tensors in a ``NamedTuple`` whose static per-layer shapes come from
:class:`GraphConfig`.

Shards are stored as ``.npz`` files with a JSON-encoded config header -- the
same format the JAX package writes, so a shard saved by either package loads
in the other.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ggnn_torch.config import GraphConfig

__all__ = ["Graph", "empty_graph", "save_graph_shard", "load_graph_shard"]


class Graph(NamedTuple):
    """One graph shard.

    Attributes:
      neighbors: tuple of L tensors, layer l: [Ns[l], KBuild] int32 -- neighbor
        ids *within layer l* (first KL local links, last KF foreign links).
      selection: tuple of L tensors; selection[l] for l>=1: [Ns[l]] int32 --
        id of each layer-l node in layer l-1. selection[0] is a placeholder
        of shape [0].
      translation: tuple of L tensors; translation[l] for l>=1: [Ns[l]] int32
        -- id of each layer-l node in layer 0 (the base). translation[0] is a
        placeholder of shape [0].
      nn1_stats: [2] f32 -- {mean, max} of 1-NN distances on layer 0
        (graph.h:47-50; sqrt'ed for Euclidean).
    """

    neighbors: tuple
    selection: tuple
    translation: tuple
    nn1_stats: torch.Tensor

    def to(self, device) -> "Graph":
        """The same graph with every tensor on ``device``."""
        return Graph(*(tuple(t.to(device) for t in f) if isinstance(f, tuple)
                       else f.to(device) for f in self))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for f in self for t in (f if isinstance(f, tuple) else (f,)))


def empty_graph(config: GraphConfig, device) -> Graph:
    """An all-invalid graph shard with the config's geometry on ``device``:
    every id -1, ``nn1_stats`` zero."""
    def invalid(*shape):
        return torch.full(shape, -1, dtype=torch.int32, device=device)

    return Graph(
        neighbors=tuple(invalid(config.Ns[l], config.KBuild)
                        for l in range(config.L)),
        selection=tuple(invalid(config.Ns[l] if l else 0) for l in range(config.L)),
        translation=tuple(invalid(config.Ns[l] if l else 0)
                          for l in range(config.L)),
        nn1_stats=torch.zeros((2,), dtype=torch.float32, device=device),
    )


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_graph_shard(path: str | Path, graph: Graph, config: GraphConfig) -> None:
    """Store one shard: npz payload + JSON config header."""
    path = Path(path)
    payload = {"config": json.dumps(config.to_dict())}
    for l in range(config.L):
        payload[f"neighbors_{l}"] = _np(graph.neighbors[l])
        if l:
            payload[f"selection_{l}"] = _np(graph.selection[l])
            payload[f"translation_{l}"] = _np(graph.translation[l])
    payload["nn1_stats"] = _np(graph.nn1_stats)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **payload)


def load_graph_shard(path: str | Path, device="cpu") -> tuple[Graph, GraphConfig]:
    """Load one shard; returns (graph on ``device``, config from the header)."""
    path = Path(path)
    with np.load(path, allow_pickle=False) as f:
        cfg_dict = json.loads(str(f["config"]))
        config = GraphConfig.create(
            N=cfg_dict["N"], D=cfg_dict["D"], KBuild=cfg_dict["KBuild"]
        )
        # verify stored geometry matches the re-derived one
        for key in ("KF", "G", "S", "S0", "S0_off", "N_all", "ST_all"):
            if cfg_dict[key] != getattr(config, key):
                raise ValueError(
                    f"{path}: stored graph geometry mismatch on {key}: "
                    f"{cfg_dict[key]} != {getattr(config, key)}"
                )

        def t(name):
            return torch.from_numpy(np.ascontiguousarray(f[name])).to(device)

        empty = torch.zeros((0,), dtype=torch.int32, device=device)
        graph = Graph(
            tuple(t(f"neighbors_{l}") for l in range(config.L)),
            tuple(t(f"selection_{l}") if l else empty for l in range(config.L)),
            tuple(t(f"translation_{l}") if l else empty for l in range(config.L)),
            t("nn1_stats"),
        )
    return graph, config
