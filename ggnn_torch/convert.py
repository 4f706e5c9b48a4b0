"""State carried across from the JAX package.

The JAX package's ``Graph`` and ``FusedIndex`` are NamedTuples of arrays;
hand their fields over as numpy arrays (``np.asarray`` of each leaf, or the
NamedTuple itself -- its leaves convert the same way) and get the port's
tensors on a given device. The graph's ``.npz`` shard format is shared
outright (``graph.save_graph_shard`` / ``load_graph_shard``).
"""

from __future__ import annotations

import numpy as np
import torch

from ggnn_torch.graph import Graph
from ggnn_torch.query.fused import FusedIndex

__all__ = ["graph_from_numpy", "fused_index_from_numpy"]


def _fields(obj) -> dict:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _t(x, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(x))
    if not a.flags.writeable:  # arrays from JAX are read-only
        a = a.copy()
    return torch.from_numpy(a).to(device)


def graph_from_numpy(graph, device="cpu") -> Graph:
    """A :class:`Graph` from the JAX package's graph fields
    (``neighbors``, ``selection``, ``translation`` tuples and ``nn1_stats``)."""
    f = _fields(graph)
    return Graph(
        neighbors=tuple(_t(x, device) for x in f["neighbors"]),
        selection=tuple(_t(x, device) for x in f["selection"]),
        translation=tuple(_t(x, device) for x in f["translation"]),
        nn1_stats=_t(f["nn1_stats"], device),
    )


def fused_index_from_numpy(index, device="cpu") -> FusedIndex:
    """A :class:`FusedIndex` from the JAX package's index fields, of any
    group and code width.

    The JAX index keeps each group's walk metadata as one packed row
    (neighbour ids, then the bit-cast f32 squared norms at a lane offset),
    both in the blocks' fetch-column order; they are split here into the
    port's two tensors in that stored order.
    """
    f = _fields(index)
    meta = np.asarray(f["meta"])
    Kc = np.asarray(f["nbr_ids"]).shape[1]
    H = max(64, -(-Kc // 64) * 64)  # lane offset of the norms half
    ids = np.ascontiguousarray(meta[:, :Kc])
    sq = np.ascontiguousarray(meta[:, H : H + Kc]).view(np.float32)
    return FusedIndex(
        nbr_ids=_t(ids, device),
        blocks=_t(f["blocks"], device),
        nbr_sq=_t(sq, device),
        group_of=_t(f["group_of"], device),
        members=_t(f["members"], device),
        scale=_t(f["scale"], device),
        zero=_t(f["zero"], device),
        rep_ids=_t(f["rep_ids"], device).to(torch.int32),
        rep_vecs=_t(f["rep_vecs"], device),
        rep_sq=_t(f["rep_sq"], device),
        nn1_stats=_t(f["nn1_stats"], device),
    )
