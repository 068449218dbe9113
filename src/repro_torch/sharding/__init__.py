from .specs import ShardingRules, shard_constraint  # noqa: F401
