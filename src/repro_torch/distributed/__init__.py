"""Logical-axis sharding rules (port of ``repro.distributed``)."""
from repro_torch.distributed.sharding import (
    axis_rules,
    current_rules,
    logical_sharding,
    shard,
    TRAIN_RULES,
    SERVE_RULES,
)

__all__ = [
    "axis_rules",
    "current_rules",
    "logical_sharding",
    "shard",
    "TRAIN_RULES",
    "SERVE_RULES",
]
