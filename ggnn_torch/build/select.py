"""Weighted reservoir sampling promotion to the next layer.

Replacement for the reference ``WRSSelectionKernel``
(src/ggnn/construction/wrs_select_layer.cu:41-102): Efraimidis-Spirakis keys
``e = -log(u) / nn1_dist`` favor points in sparse regions; the per-segment
cub::BlockRadixSort becomes a batched sort over reshaped segments.
"""

from __future__ import annotations

import torch

from ggnn_torch.config import GraphConfig

__all__ = ["wrs_select_layer"]

_EPS = float(torch.finfo(torch.float32).eps)


def _select(rng_u, nn1_dist, translation_layer, *, num_segments: int, S: int,
            S_offset: int, Sglob: int, G: int, SG: int, SG_offset: int,
            use_translation: bool, N_next: int):
    """Selection given the uniforms ``rng_u`` [Ns[layer]] in (0, 1]."""
    dev = nn1_dist.device
    W = S + (1 if S_offset else 0)
    b = torch.arange(num_segments, device=dev)
    if S_offset:
        starts = b * S + torch.clamp_max(b, S_offset)
        sizes = S + (b < S_offset).to(torch.int64)
    else:
        starts = b * S
        sizes = torch.full((num_segments,), S, dtype=torch.int64, device=dev)

    offs = torch.arange(W, device=dev)[None, :]
    node_ids = starts[:, None] + offs
    valid = offs < sizes[:, None]
    safe = torch.where(valid, node_ids, 0)

    # Efraimidis-Spirakis keys (wrs_select_layer.cu:55-65); invalid slots lose
    e = -torch.log(rng_u[safe]) / (nn1_dist[safe] + _EPS)
    e = torch.where(valid, e, float("-inf"))
    # sort descending by key, carry node ids
    _, order = torch.sort(-e, dim=-1, stable=True)
    winners = torch.gather(safe, -1, order)

    # number of points each segment contributes to its upper segment
    nth = b % G
    num_sel = SG + (nth < SG_offset).to(torch.int64)
    upper_segment = b // G
    dest0 = upper_segment * Sglob + nth * SG + torch.clamp_max(nth, SG_offset)

    max_sel = SG + (1 if SG_offset else 0)
    slot = torch.arange(max_sel, device=dev)[None, :]
    chosen = winners[:, :max_sel]
    sel_valid = (slot < num_sel[:, None]) & (dest0[:, None] + slot < N_next)
    dest = (dest0[:, None] + slot)[sel_valid]
    picked = chosen[sel_valid]

    selection = torch.full((N_next,), -1, dtype=torch.int32, device=dev)
    translation = torch.full((N_next,), -1, dtype=torch.int32, device=dev)
    selection[dest] = picked.to(torch.int32)
    trans_vals = translation_layer[picked] if use_translation else picked
    translation[dest] = trans_vals.to(torch.int32)
    return selection, translation


def wrs_select_layer(
    generator: torch.Generator,
    nn1_dist: torch.Tensor,
    translation_l: torch.Tensor | None,
    cfg: GraphConfig,
    layer: int,
):
    """Select/translate layer ``layer+1`` from layer ``layer``.

    ``generator`` draws the selection uniforms (on ``nn1_dist``'s device).
    Returns (selection [Ns[layer+1]], translation [Ns[layer+1]]) where
    selection maps layer-(l+1) ids to layer-l ids and translation maps them
    to base (layer-0) ids, mirroring graph_construction.cu:163-187.
    """
    Ns = cfg.Ns[layer]
    # curand uniform is (0, 1]; torch.rand is [0, 1) -- flip
    u = 1.0 - torch.rand((Ns,), generator=generator, device=nn1_dist.device)
    return _select(
        u,
        nn1_dist,
        translation_l,
        num_segments=cfg.Bs[layer],
        S=cfg.layer_segment_size(layer),
        S_offset=cfg.layer_segment_offset_count(layer),
        Sglob=cfg.S,
        G=cfg.G,
        SG=cfg.SG,
        SG_offset=cfg.SG_off,
        use_translation=layer > 0,
        N_next=cfg.Ns[layer + 1],
    )
