"""Where the port runs: the card unless the caller names another device."""

from __future__ import annotations

import sys

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none; any
    other value (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is taken as
    given. Nothing falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the "
                'caller passes device="cpu"'
            )
        return torch.device("cuda")
    return torch.device(device)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor spread over a mesh's devices),
    without importing DTensor: none exists before
    ``torch.distributed.tensor`` is imported."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)
