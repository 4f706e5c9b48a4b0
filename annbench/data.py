"""The general data generator: a configuration's base and a traffic mix's
query pool, drawn on the device from the run's seed.

Every configuration's ``data`` group names the same few parameters: a
``d_latent``-dimensional Gaussian latent through a random linear map to
``dim`` dimensions (``bench_torch.make_dataset``'s model of descriptor
sets: one connected continuum of low intrinsic dimension), scaled by
``scale``, shifted by ``offset``, plus isotropic Gaussian ``noise``, then
optionally clipped to ``clip`` and normalised to unit length
(``normalize``). The base and the pool come from one map, so the queries
follow the base's distribution; they are separate draws, so no query is a
base point.
"""

from __future__ import annotations

import torch

__all__ = ["generate", "schedule"]

# rows drawn per call: a few large calls, a bounded temporary
_CHUNK = 1 << 18


def _draw(gen, w, m, data, device):
    d_latent, dim = w.shape
    out = torch.empty((m, dim), dtype=torch.float32, device=device)
    for lo in range(0, m, _CHUNK):
        rows = min(_CHUNK, m - lo)
        z = torch.randn((rows, d_latent), generator=gen, device=device)
        x = torch.randn((rows, dim), generator=gen, device=device)
        x.mul_(float(data["noise"])).add_(z @ w, alpha=float(data["scale"]))
        x.add_(float(data["offset"]))
        if data.get("clip") is not None:
            lo_v, hi_v = data["clip"]
            x.clamp_(float(lo_v), float(hi_v))
        if data.get("normalize"):
            x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-30))
        out[lo : lo + rows] = x
    return out


@torch.no_grad()
def generate(data: dict, n_base: int, dim: int, n_pool: int, seed: int,
             device) -> tuple[torch.Tensor, torch.Tensor]:
    """(base [n_base, dim] f32, pool [n_pool, dim] f32) on ``device``, the
    same for the same ``seed`` on the same kind of device. Products run in
    full f32 (TF32 off)."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d_latent = int(data["d_latent"])
    w = torch.randn((d_latent, dim), generator=gen, device=device)
    w.div_(d_latent ** 0.5)
    base = _draw(gen, w, n_base, data, device)
    pool = _draw(gen, w, n_pool, data, device)
    return base, pool


def schedule(traffic: dict):
    """The calls of a closed loop of one client, in order: an endless
    iterator of (first pool row, rows). Every call asks ``batch`` rows,
    consecutive in the pool, and wraps to the start where the pool has
    fewer rows left."""
    rows, pool = int(traffic["batch"]), int(traffic["pool"])
    if not 0 < rows <= pool:
        raise ValueError(f"a batch of {rows} rows does not fit the pool of {pool}")
    lo = 0
    while True:
        if lo + rows > pool:
            lo = 0
        yield lo, rows
        lo += rows
