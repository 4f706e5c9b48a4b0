"""Operations and bytes of one ``approx_topk`` launch, from its shapes.

A frozen copy of ``chip_smoke.approx_bound``: the [B, n] f32 dot tile,
both norm vectors read once and the [B, k] distances and positions
written once, against the epilogue's 4 f32 operations an element (add,
multiply, subtract, compare). Peaks of one H100 SXM (NVIDIA's data sheet,
dense, 700 W): 3.35 TB/s of HBM, 67 TFLOP/s of f32 outside the tensor
cores.
"""

from __future__ import annotations

__all__ = ["F32_FLOP_S", "HBM_BYTES_S", "approx_bound"]

HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12


def approx_bound(B: int, n: int, k: int) -> tuple[int, float, str]:
    """(bytes, the least ms the card could take, "bytes" or "operations")
    of one approximate top-k over a [B, n] dot tile at ``k``."""
    nbytes = B * n * 4 + n * 4 + B * 4 + B * k * 8
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = 4 * B * n / F32_FLOP_S * 1e3
    return nbytes, max(bytes_ms, ops_ms), (
        "bytes" if bytes_ms >= ops_ms else "operations")
