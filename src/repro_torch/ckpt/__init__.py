from .checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
