from .pipeline import PipelineState, ShardedTokenPipeline  # noqa: F401
from .placement import plan_shard_sources  # noqa: F401
