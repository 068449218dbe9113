"""Logical-axis sharding rules, single-device part.

The port's copy of the ``ShardingRules`` dataclass of
``repro/sharding/specs.py``, so a model function takes the same
arguments as the reference's. The port runs on one device and sets no
mesh, so ``shard_constraint`` returns its input, as the reference's does
without a mesh (``specs.py:149-157``). Meshes, placements and the rest of
that file are ROADMAP Queue 1 #11.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to mesh axes (str, tuple of str, or None)."""

    batch: Any = ("pod", "data")
    fsdp: Any = "data"  # parameter sharding (ZeRO-3 style)
    tp: Any = "model"  # tensor parallel
    seq: Any = None  # sequence/context parallel
    expert: Any = "model"  # expert parallel
    # set fsdp_pod to also shard params/optimizer over the pod axis (ZeRO-3
    # across pods; trades parameter all-gather traffic on DCN for memory).
    fsdp_pod: bool = False

    def resolve(self, logical: str | None):
        if logical is None or logical == "layers":
            return None  # the stacked-layer axis is never sharded
        return {
            "batch": self.batch,
            "fsdp": self._fsdp_axes(),
            "tp": self.tp,
            "seq": self.seq,
            "expert": self.expert,
        }[logical]

    def _fsdp_axes(self):
        if self.fsdp is None:
            return None
        if self.fsdp_pod:
            base = self.fsdp if isinstance(self.fsdp, tuple) else (self.fsdp,)
            return ("pod",) + base
        return self.fsdp


def shard_constraint(x, rules: ShardingRules, *logical: str | None):
    """No mesh on one device: ``x`` as it is."""
    return x
