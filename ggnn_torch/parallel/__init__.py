"""Queries and brute force over shards on several devices in one process."""

from ggnn_torch.parallel.sharded import (
    merge_over_devices,
    per_device,
    run_on_devices,
    sharded_bf_query,
    sharded_fused_query,
    sharded_query,
)

__all__ = [
    "merge_over_devices",
    "per_device",
    "run_on_devices",
    "sharded_query",
    "sharded_fused_query",
    "sharded_bf_query",
]
