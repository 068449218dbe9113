"""Hand-written Hopper kernels of the port, each beside its plain version."""

from __future__ import annotations

import torch

from repro_torch.device import is_dtensor


def refuse_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad. The
    flash-attention and SSD kernels are forward only, like the Pallas
    kernels they replace; autograd would run them and drop the gradient
    of their inputs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward kernel: train with "
            "cfg.use_pallas=False, as the reference does, or call it under "
            "torch.no_grad()"
        )


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise if any of ``tensors`` is a DTensor. A kernel reads one
    device's memory: a DTensor reaches it only as the local shards of an
    explicit boundary (``to_local`` on placements where a shard computes
    the same function), never as a fall-back to the plain version."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(
            f"{name} got a DTensor: hand the kernel local shards "
            "(to_local) on placements where a shard computes the same "
            "function"
        )


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as TMA reads it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
