from .checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from .replicate import replicate_checkpoint  # noqa: F401

__all__ = [
    "CheckpointManager",
    "load_checkpoint",
    "replicate_checkpoint",
    "save_checkpoint",
]
