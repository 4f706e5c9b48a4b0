"""GGNN in PyTorch: graph-based approximate nearest-neighbor search on CUDA.

A port of the JAX package beside it in this repository, which stays the
reference the port is tested against. Plain tensor code is
PyTorch; the anchor-block fetch + dot of the quantized walk is a CUDA kernel
written for Hopper (``csrc/adjacency_dot.cu``).

Importing the package turns TF32 off for f32 matrix products and cuDNN
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``): distances, brute force and the exact
re-rank must be full f32, as the JAX package's ``Precision.HIGHEST``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from ggnn_torch.config import DistanceMeasure, GraphConfig  # noqa: E402
from ggnn_torch.evaluator import Evaluation, Evaluator  # noqa: E402
from ggnn_torch.ggnn import GGNN, Results, ResultsFuture  # noqa: E402
from ggnn_torch.utils.logging import get_log_level, set_log_level  # noqa: E402

__all__ = [
    "GGNN",
    "Results",
    "ResultsFuture",
    "Evaluator",
    "Evaluation",
    "DistanceMeasure",
    "GraphConfig",
    "set_log_level",
    "get_log_level",
]
