"""Single-source-of-truth parameter definitions.

Model code declares parameters as ``ParamDef`` trees (nested dicts of
shape + logical sharding axes + init rule), as the reference does
(``repro/models/params.py``). From one abstract tree the port derives the
initialized parameters (``materialize``) and the parameter count.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import leaves


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple[Any, ...]  # logical axis per dim (None | "fsdp" | "tp" | ...)
    init: str = "normal"  # "normal" | "zeros" | "ones" | "embed"
    fan_in: int | None = None  # stddev = 1/sqrt(fan_in) when set
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def materialize(tree, generator: torch.Generator, device=None):
    """ParamDef tree -> initialized parameter tree on ``device`` (the card
    unless the caller names another; ``generator`` must live there too).
    Leaves draw from ``generator`` one after another in ``leaves`` order,
    each written in place, so a full-size model needs no temporary of its
    largest leaf."""
    device = resolve_device(device)
    g = generator.device
    if g.type != device.type or (
        device.index is not None and g.index is not None
        and g.index != device.index
    ):
        raise ValueError(
            f"generator on {g} cannot draw parameters on {device}"
        )

    def init_one(pd: ParamDef):
        t = torch.empty(pd.shape, dtype=pd.dtype, device=device)
        if pd.init == "zeros":
            return t.zero_()
        if pd.init == "ones":
            return t.fill_(1.0)
        if pd.init == "embed":
            return t.normal_(0.0, 0.02, generator=generator)
        fan = (
            pd.fan_in
            if pd.fan_in
            else (pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1])
        )
        std = 1.0 / np.sqrt(max(fan, 1))
        return t.normal_(0.0, float(std), generator=generator)

    flat = {path: init_one(pd) for path, pd in leaves(tree)}
    return tree_map_paths(lambda path, _: flat[path], tree)


def tree_map_paths(fn, tree, prefix: str = ""):
    """Map ``fn(dotted path, leaf)`` over a nested dict."""
    if isinstance(tree, dict):
        return {
            k: tree_map_paths(fn, v, f"{prefix}.{k}" if prefix else k)
            for k, v in tree.items()
        }
    return fn(prefix, tree)


def count(tree) -> int:
    return int(sum(int(np.prod(pd.shape)) for _, pd in leaves(tree)))
