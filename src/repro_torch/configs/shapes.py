"""Assigned input shapes (the brief's 4 LM shapes) and per-cell applicability.

  train_4k      seq 4,096  x global_batch 256   -> train_step
  prefill_32k   seq 32,768 x global_batch 32    -> serve prefill
  decode_32k    seq 32,768 x global_batch 128   -> serve_step (1 new token,
                                                   KV/SSM state of seq_len)
  long_500k     seq 524,288 x global_batch 1    -> serve_step; requires a
                sub-quadratic context mechanism (SSM / hybrid / SWA). Pure
                full-attention archs skip it (recorded as N/A per DESIGN.md).
"""

from __future__ import annotations

import dataclasses

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "pure full-attention arch: 500k decode requires sub-quadratic "
            "context (DESIGN.md §4)"
        )
    return True, ""


def cells(archs: dict[str, ModelConfig]):
    """All 40 (arch, shape) cells with applicability annotations."""
    out = []
    for aname, cfg in archs.items():
        for sname, shape in SHAPES.items():
            runs, why = applicable(cfg, shape)
            out.append((aname, sname, runs, why))
    return out
