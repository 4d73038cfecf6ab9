"""Logical-axis -> mesh-axis sharding rules (the port of ``repro.sharding``)."""
from repro_torch.sharding.rules import (
    ShardingRules,
    batch_axes_for_mesh,
    build_param_specs,
    default_rules,
    spec_for_axes,
)

__all__ = [
    "ShardingRules",
    "default_rules",
    "spec_for_axes",
    "build_param_specs",
    "batch_axes_for_mesh",
]
