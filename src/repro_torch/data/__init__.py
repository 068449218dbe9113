from .pipeline import PipelineState, ShardedTokenPipeline  # noqa: F401
