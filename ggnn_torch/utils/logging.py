"""VLOG-style verbosity control.

The reference exposes glog verbosity 0-4 to Python (nanobind.cu:151,
``set_log_level``); we mirror the interface on top of the std logging module.
"""

from __future__ import annotations

import logging
import sys

__all__ = ["set_log_level", "get_log_level", "vlog", "logger"]

logger = logging.getLogger("ggnn_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[ggnn_torch] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

_verbosity = 0


def set_log_level(level: int) -> None:
    """Set VLOG verbosity (0-4), mirroring ggnn.set_log_level."""
    global _verbosity
    _verbosity = int(level)


def get_log_level() -> int:
    return _verbosity


def vlog(level: int, msg: str, *args) -> None:
    """Log ``msg`` if the current verbosity is >= ``level``."""
    if _verbosity >= level:
        logger.info(msg if not args else msg % args)
