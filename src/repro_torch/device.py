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


def note_meta(event: str, *args) -> None:
    """Report work that a ``meta`` route stood in for (a kernel it did
    not launch, a ring hop it did not send) to the innermost dispatch
    mode that records it: ``mode.note_<event>(*args)``, the dry run's
    step recorder (``launch/hlo_stats.py``). Under no such mode nothing
    happens. Looked up by method name, so the kernels and the ring know
    nothing of the dry run."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        note = getattr(mode, f"note_{event}", None)
        if note is not None:
            note(*args)
            return
