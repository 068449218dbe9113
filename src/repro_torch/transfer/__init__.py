"""The port's transfer plane: scenarios, the sim dispatcher and its engine."""

from .simconfig import SimConfig  # noqa: F401
from .sim import simulate  # noqa: F401
from .events import (  # noqa: F401
    GrayFailure,
    JobSimResult,
    LinkDegrade,
    LinkRestore,
    MultiSimResult,
    TransferJob,
    VMFailure,
)

__all__ = [
    "GrayFailure",
    "JobSimResult",
    "LinkDegrade",
    "LinkRestore",
    "MultiSimResult",
    "SimConfig",
    "TransferJob",
    "VMFailure",
    "simulate",
]
