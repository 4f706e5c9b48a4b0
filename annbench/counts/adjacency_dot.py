"""Bytes of ``adjacency_dot`` launches, from the anchors they fetched.

One launch takes ``rows`` query rows of ``P`` anchors each; an anchor of
-1 reads nothing and writes nothing. Each fetched anchor's block of ``CR``
code rows of ``D`` bytes is read once and its ``CR`` f32 dots written
(``2 * CR`` with int4 codes, two neighbours a byte); each query row's ``D``
f32 and its ``P`` anchor ids are read once. Operations (2 a code) stay far
below the card's ridge, so the bytes bound the time. The peak is one H100
SXM's HBM (``counts/approx_topk.py``).
"""

from __future__ import annotations

from annbench.counts.approx_topk import HBM_BYTES_S

__all__ = ["HBM_BYTES_S", "adjacency_bytes", "bytes_ms"]


def adjacency_bytes(anchors: int, rows: int, P: int, CR: int, D: int,
                    nibbles: bool = False) -> int:
    """Bytes moved by launches over ``rows`` query rows in all that fetched
    ``anchors`` code blocks of ``CR`` x ``D`` bytes."""
    outputs = 2 * CR if nibbles else CR
    return anchors * (CR * D + outputs * 4) + rows * (D * 4 + P * 4)


def bytes_ms(nbytes: int) -> float:
    """The least ms the card could move ``nbytes`` in."""
    return nbytes / HBM_BYTES_S * 1e3
