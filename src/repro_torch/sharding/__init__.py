from .specs import (
    ShardingRules,
    current_mesh,
    logical_to_physical,
    make_param_shardings,
    set_mesh,
    shard_constraint,
    shardings_for,
)

__all__ = [
    "ShardingRules",
    "current_mesh",
    "logical_to_physical",
    "make_param_shardings",
    "set_mesh",
    "shard_constraint",
    "shardings_for",
]
