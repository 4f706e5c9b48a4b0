"""Distance computation primitives.

Replacement for the reference's block-cooperative ``Distance``
(include/ggnn/cuda_utils/distance.cuh:34-164): distances are computed as
dense f32 tiles, ``[M, D] x [D, N] -> [M, N]`` (or batched ``[B, K, D]``
gathers reduced against per-row queries). The package turns TF32 off at
import (``ggnn_torch/__init__.py``), so every f32 product here runs in full
f32 -- the counterpart of the JAX package's ``Precision.HIGHEST``.

Semantics match the reference:
  * Euclidean -> *squared* L2 (sqrt is only applied to 1-NN statistics).
  * Cosine    -> ``|1 - <a,b> / sqrt(|a|^2 |b|^2)|``, and 1.0 when either
    norm is zero (distance.cuh:140-159).
"""

from __future__ import annotations

import torch

from ggnn_torch.config import DistanceMeasure

__all__ = ["EMPTY_DIST", "squared_norms", "dist_block", "dist_gathered", "finish"]

EMPTY_DIST = float("inf")


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, f32. ``x``: [N, D] (any real dtype)."""
    x = _as_f32(x)
    return torch.sum(x * x, dim=-1)


def finish(dot, a_sq, b_sq, measure: DistanceMeasure) -> torch.Tensor:
    """Distances from dot products and (broadcastable) squared norms."""
    if measure == DistanceMeasure.Euclidean:
        return torch.clamp_min(a_sq + b_sq - 2.0 * dot, 0.0)
    if measure == DistanceMeasure.Cosine:
        norm_sq = a_sq * b_sq
        safe = norm_sq > 0.0
        d = torch.abs(1.0 - dot * torch.rsqrt(torch.where(safe, norm_sq, 1.0)))
        return torch.where(safe, d, 1.0)
    raise ValueError(f"unknown measure {measure}")


def dist_block(
    q: torch.Tensor,
    c: torch.Tensor,
    measure: DistanceMeasure = DistanceMeasure.Euclidean,
    *,
    q_sq: torch.Tensor | None = None,
    c_sq: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dense distance tile between query rows and candidate rows.

    q: [M, D]; c: [N, D]; q_sq / c_sq: optional squared norms ([M] / [N]).
    Returns [M, N] f32 distances.
    """
    q = _as_f32(q)
    c = _as_f32(c)
    dot = q @ c.T
    if q_sq is None:
        q_sq = squared_norms(q)
    if c_sq is None:
        c_sq = squared_norms(c)
    return finish(dot, q_sq[:, None], c_sq[None, :], DistanceMeasure(measure))


def dist_gathered(
    q: torch.Tensor,
    cand: torch.Tensor,
    measure: DistanceMeasure = DistanceMeasure.Euclidean,
    *,
    q_sq: torch.Tensor | None = None,
    cand_sq: torch.Tensor | None = None,
) -> torch.Tensor:
    """Distances between per-row queries and per-row gathered candidates.

    q: [B, D]; cand: [B, K, D]; q_sq: [B]; cand_sq: [B, K].
    Returns [B, K] f32 distances.
    """
    q = _as_f32(q)
    cand = _as_f32(cand)
    dot = torch.einsum("bd,bkd->bk", q, cand)
    if q_sq is None:
        q_sq = squared_norms(q)
    if cand_sq is None:
        cand_sq = squared_norms(cand)
    return finish(dot, q_sq[:, None], cand_sq, DistanceMeasure(measure))
