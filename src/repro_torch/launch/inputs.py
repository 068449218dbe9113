"""Stand-ins for every model input, plus their logical sharding trees (the
port of ``repro/launch/inputs.py``). Where the reference builds
``ShapeDtypeStruct``s the port builds tensors on the ``meta`` device, of
the same shapes and types: they allocate nothing either.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import init_decode_state, param_shape_dtypes
from repro_torch.models.model import decode_state_logical


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_sds(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    sds = {
        "tokens": _meta((b, s), torch.int32),
        "labels": _meta((b, s), torch.int32),
    }
    dt = getattr(torch, cfg.dtype)
    if cfg.is_vlm:
        sds["vision"] = _meta((b, cfg.num_vision_tokens, cfg.d_model), dt)
    if cfg.is_enc_dec:
        sds["frames"] = _meta((b, cfg.num_frames, cfg.d_model), dt)
    return sds


def train_batch_logical(cfg: ModelConfig) -> dict:
    spec = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.is_vlm:
        spec["vision"] = ("batch", None, None)
    if cfg.is_enc_dec:
        spec["frames"] = ("batch", None, None)
    return spec


def decode_state_sds(cfg: ModelConfig, shape: ShapeSpec):
    """Decode state stand-in with a KV/SSM context of shape.seq_len."""
    return init_decode_state(cfg, shape.global_batch, shape.seq_len,
                             device="meta")


def decode_tokens_sds(cfg: ModelConfig, shape: ShapeSpec):
    return _meta((shape.global_batch, 1), torch.int32)


def decode_logical(cfg: ModelConfig) -> dict:
    return decode_state_logical(cfg)


def param_sds(cfg: ModelConfig, dtype=None):
    sds = param_shape_dtypes(cfg)
    if dtype is None:
        return sds
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return _cast(sds, dt)


def _cast(tree, dt):
    if isinstance(tree, dict):
        return {k: _cast(v, dt) for k, v in tree.items()}
    return _meta(tree.shape, dt)
