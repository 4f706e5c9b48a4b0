"""Where the port keeps the shared libraries it builds at first use.

The adjacency kernel (``nvcc``) and the native host runtime (``g++``) are
compiled from the sources in the package into one directory, each library
named by a hash of its source and its compiler flags: a library built from
another source, or with other flags, is never loaded, whatever the files'
times. ``GGNN_TORCH_CACHE`` names the directory; without it, a package in
a source checkout (a ``pyproject.toml`` beside the package directory) uses
``build/kernels/`` there, and an installed package ``ggnn_torch`` in the
temporary directory, never its own tree.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from pathlib import Path

__all__ = ["cache_dir", "keyed_library"]


def cache_dir() -> Path:
    d = os.environ.get("GGNN_TORCH_CACHE")
    if d:
        return Path(d)
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "kernels"
    return Path(tempfile.gettempdir()) / "ggnn_torch"


def keyed_library(stem: str, source: Path, flags) -> Path:
    """``<cache_dir>/<stem>_<sha256[:16]>.so`` of the source's bytes and the
    flags it is compiled with."""
    h = hashlib.sha256(Path(source).read_bytes())
    for flag in flags:
        h.update(b"\0" + str(flag).encode())
    return cache_dir() / f"{stem}_{h.hexdigest()[:16]}.so"
