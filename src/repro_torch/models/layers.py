"""Shared layers: RMSNorm, MLP variants, rotary embeddings, embedding/unembed
(the port of ``repro/models/layers.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.specs import (ShardingRules, replicate_like,
                                     shard_constraint, unshard)
from .params import ParamDef


# ------------------------------------------------------------------- rmsnorm
def rmsnorm_def(d: int) -> ParamDef:
    return ParamDef((d,), (None,), init="ones")


def rmsnorm(x, scale, eps: float):
    """Computed in f32, returned in x's type."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


# ----------------------------------------------------------------------- mlp
def mlp_defs(cfg: ModelConfig, lead: tuple[int, ...] = ()) -> dict:
    """Gated (SiLU/GELU) or squared-ReLU MLP parameter defs."""
    d, f = cfg.d_model, cfg.d_ff
    ll = tuple(["layers"] * len(lead))
    defs = {
        "wi": ParamDef(lead + (d, f), ll + ("fsdp", "tp"), fan_in=d),
        "wo": ParamDef(lead + (f, d), ll + ("tp", "fsdp"), fan_in=f),
    }
    if cfg.activation != "relu2":  # gated variants carry a second in-proj
        defs["wg"] = ParamDef(lead + (d, f), ll + ("fsdp", "tp"), fan_in=d)
    return defs


def mlp(cfg: ModelConfig, rules: ShardingRules, p: dict, x):
    """x: [B, S, D] -> [B, S, D]. GELU is the tanh approximation, which is
    ``jax.nn.gelu``'s default."""
    dt = x.dtype
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(dt))
    h = shard_constraint(h, rules, "batch", None, "tp")
    if cfg.activation == "relu2":  # Nemotron-4 squared ReLU
        h = torch.square(F.relu(h))
    else:
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(dt))
        if cfg.activation == "silu":
            h = F.silu(g) * h
        else:
            h = F.gelu(g, approximate="tanh") * h
    out = torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt))
    return shard_constraint(out, rules, "batch", None, None)


# ---------------------------------------------------------------------- rope
def rope(x, positions, theta: float):
    """Rotary position embedding on halves (not interleaved pairs), in f32.
    x: [..., S, H, Dh], positions: [..., S]."""
    dh = x.shape[-1]
    half = dh // 2
    freq = replicate_like(theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    ), positions)
    angles = positions[..., :, None].float() * freq  # [..., S, half]
    angles = angles[..., :, None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- embedding
def embed_defs(cfg: ModelConfig) -> dict:
    tok_logical = (None, "tp") if cfg.embed_dmodel_shard else ("tp", "fsdp")
    d = {"tok": ParamDef((cfg.vocab_size, cfg.d_model), tok_logical,
                         init="embed")}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef(
            (cfg.d_model, cfg.vocab_size), ("fsdp", "tp"), fan_in=cfg.d_model
        )
    return d


def embed(cfg: ModelConfig, rules: ShardingRules, p: dict, tokens, dtype):
    # DTensor's lookup into a vocab-sharded table fails under a
    # batch-sharded index (its masked partial sum); the table is gathered
    # whole at its use, as FSDP gathers a weight
    x = F.embedding(tokens.long(), unshard(p["tok"])).to(dtype)
    return shard_constraint(x, rules, "batch", "seq", None)


def unembed_matrix(cfg: ModelConfig, p: dict, dtype):
    if cfg.tie_embeddings:
        return p["tok"].T.to(dtype)
    return p["unembed"].to(dtype)
