"""Block composition: dense / MoE / SSM / hybrid / VLM / enc-dec stacks
(the port of ``repro/models/transformer.py``).

Parameters keep the reference's stacked layout (a leading layer axis, or
[groups, per] for the Zamba2 hybrid, [groups, per-1] and [groups] for the
VLM's self- and cross-attention blocks), so converted parameters match
leaf for leaf; where the reference scans over that axis, the port loops in
Python. Three execution modes share the block math:
  train    — no caches (``models.forward``); with ``cfg.remat`` each
             block (each group for the hybrid and the VLM) is recomputed
             in the backward pass (``_maybe_remat``)
  prefill  — same math, additionally emits KV/SSM caches, stacked
  decode   — single token, caches updated in place

The VLM's cross-attention reads ``Aux.vision`` and the decoder of the
encoder-decoder reads ``Aux.memory`` (the encoder's output) in every mode;
decode recomputes their K and V at every step and layer, as the reference
does.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.specs import ShardingRules
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import mlp, mlp_defs, rmsnorm, rmsnorm_def
from .params import ParamDef


class Aux(NamedTuple):
    """Side inputs: encoder memory (enc-dec) or vision tokens (VLM)."""

    memory: Any = None  # [B, Skv, D]
    vision: Any = None  # [B, Sv, D]


# ------------------------------------------------------------ param defs
def dense_block_defs(cfg: ModelConfig, lead=()) -> dict:
    ll = tuple(["layers"] * len(lead))
    d = {
        "ln1": ParamDef(lead + (cfg.d_model,), ll + (None,), init="ones"),
        "attn": attn.attn_defs(cfg, lead),
        "ln2": ParamDef(lead + (cfg.d_model,), ll + (None,), init="ones"),
    }
    if cfg.moe is not None:
        d["ffn"] = moe_mod.moe_defs(cfg, lead)
    else:
        d["ffn"] = mlp_defs(cfg, lead)
    return d


def ssm_block_defs(cfg: ModelConfig, lead=()) -> dict:
    ll = tuple(["layers"] * len(lead))
    return {
        "ln1": ParamDef(lead + (cfg.d_model,), ll + (None,), init="ones"),
        "ssm": ssm_mod.ssm_defs(cfg, lead),
    }


def xattn_block_defs(cfg: ModelConfig, lead=()) -> dict:
    ll = tuple(["layers"] * len(lead))
    return {
        "ln1": ParamDef(lead + (cfg.d_model,), ll + (None,), init="ones"),
        "attn": attn.attn_defs(cfg, lead, cross=True),
        "ln2": ParamDef(lead + (cfg.d_model,), ll + (None,), init="ones"),
        "ffn": mlp_defs(cfg, lead),
    }


def stack_defs(cfg: ModelConfig) -> dict:
    """Parameter defs for the decoder stack of ``cfg``."""
    groups, per = cfg.scan_groups()
    if cfg.is_hybrid:
        return {
            "ssm_blocks": ssm_block_defs(cfg, lead=(groups, per)),
            "shared": dense_block_defs(cfg),  # ONE shared block (Zamba2)
        }
    if cfg.is_ssm:
        return {"ssm_blocks": ssm_block_defs(cfg, lead=(cfg.num_layers,))}
    if cfg.is_vlm:
        return {
            "self_blocks": dense_block_defs(cfg, lead=(groups, per - 1)),
            "cross_blocks": xattn_block_defs(cfg, lead=(groups,)),
        }
    if cfg.is_enc_dec:
        L = cfg.num_layers
        ll = ("layers",)
        return {
            "dec_blocks": {
                "ln1": ParamDef((L, cfg.d_model), ll + (None,), init="ones"),
                "attn": attn.attn_defs(cfg, (L,)),
                "lnx": ParamDef((L, cfg.d_model), ll + (None,), init="ones"),
                "xattn": attn.attn_defs(cfg, (L,), cross=True),
                "ln2": ParamDef((L, cfg.d_model), ll + (None,), init="ones"),
                "ffn": mlp_defs(cfg, (L,)),
            }
        }
    return {"blocks": dense_block_defs(cfg, lead=(cfg.num_layers,))}


def encoder_defs(cfg: ModelConfig) -> dict:
    return {
        "blocks": dense_block_defs(cfg, lead=(cfg.encoder_layers,)),
        "norm": rmsnorm_def(cfg.d_model),
    }


# ------------------------------------------------------------ block bodies
def dense_block(cfg, rules, p, x, positions, *, cache=None, cache_len=None,
                seen_len=None, emit_kv=None):
    h, new_cache = attn.self_attention(
        cfg, rules, p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), positions,
        cache=cache, cache_len=cache_len, seen_len=seen_len, emit_kv=emit_kv,
    )
    x = x + h
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        x = x + moe_mod.moe_mlp(cfg, rules, p["ffn"], h2)
    else:
        x = x + mlp(cfg, rules, p["ffn"], h2)
    return x, new_cache


def ssm_block(cfg, rules, p, x, *, cache=None):
    h, new_cache = ssm_mod.ssm_mixer(
        cfg, rules, p["ssm"], rmsnorm(x, p["ln1"], cfg.norm_eps), cache=cache
    )
    return x + h, new_cache


def ssm_block_prefill(cfg, rules, p, x):
    h, cache = ssm_mod.ssm_prefill_mixer(
        cfg, rules, p["ssm"], rmsnorm(x, p["ln1"], cfg.norm_eps)
    )
    return x + h, cache


def xattn_block(cfg, rules, p, x, aux_kv):
    h = attn.cross_attention(
        cfg, rules, p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), aux_kv
    )
    x = x + h
    x = x + mlp(cfg, rules, p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x


# -------------------------------------------------------------- the stacks
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Save matmul outputs without batch dims, recompute the rest: JAX's
    ``dots_with_no_batch_dims_saveable``. ``einsum`` contracts through
    ``bmm``, with a batch of 1 where the contraction has no batch dims
    (the projections) and a larger one where it has (attention scores)."""
    if op in _MATMULS or (op == torch.ops.aten.bmm.default
                          and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg: ModelConfig, fn, train: bool):
    """``fn`` recomputed in the backward pass when training with
    ``cfg.remat``: ``remat_policy`` "full" recomputes everything, "dots"
    saves the matmul outputs, "none" saves everything (no remat)."""
    if not (train and cfg.remat) or cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "dots":
        def context():
            return create_selective_checkpoint_contexts(_save_dots)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=context)
    if cfg.remat_policy != "full":
        raise ValueError(f"unknown remat policy {cfg.remat_policy!r}")
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _at(tree, *idx):
    """The slice ``[idx]`` of every leaf of a nested dict (views)."""
    if isinstance(tree, dict):
        return {k: _at(v, *idx) for k, v in tree.items()}
    return tree[idx]


def _store(stacked: dict | None, lead: tuple[int, ...], idx: tuple,
           cache: dict) -> dict:
    """Write one layer's cache leaves at ``idx`` of the stacked cache,
    allocating it (``lead`` + the leaf's shape) at the first layer."""
    if stacked is None:
        stacked = {k: torch.empty(lead + tuple(v.shape), dtype=v.dtype,
                                  device=v.device) for k, v in cache.items()}
    for k, v in cache.items():
        stacked[k][idx] = v
    return stacked


def run_stack(
    cfg: ModelConfig,
    rules: ShardingRules,
    params: dict,
    x,
    positions,
    aux: Aux = Aux(),
    *,
    mode: str = "train",  # "train" | "prefill" | "decode"
    state: dict | None = None,  # decode caches (stacked)
    t_max: int | None = None,  # KV buffer length for prefill caches
    cache_len=None,  # decode: KV write slot (0-d tensor)
    seen_len=None,  # decode: total tokens seen (mask horizon)
):
    """Returns (hidden, caches). ``caches`` is None in train mode; in prefill
    mode a freshly built stacked cache; in decode mode ``state``'s caches,
    updated in place."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    args = (cfg, rules, params, x, positions, aux, mode, state, t_max,
            cache_len, seen_len)
    if cfg.is_hybrid:
        return _hybrid_stack(*args)
    if cfg.is_ssm:
        return _ssm_stack(*args)
    if cfg.is_vlm:
        return _vlm_stack(*args)
    if cfg.is_enc_dec:
        return _encdec_stack(*args)
    return _dense_stack(*args)


def _dense_stack(cfg, rules, params, x, positions, aux, mode, state, t_max,
                 cache_len, seen_len):
    blocks, n = params["blocks"], cfg.num_layers
    if mode == "train":
        body = _maybe_remat(
            cfg, lambda h, p: dense_block(cfg, rules, p, h, positions)[0],
            True)
        for i in range(n):
            x = body(x, _at(blocks, i))
        return x, None
    kv = None
    for i in range(n):
        p = _at(blocks, i)
        if mode == "decode":
            x, _ = dense_block(cfg, rules, p, x, positions,
                               cache=_at(state["kv"], i), cache_len=cache_len,
                               seen_len=seen_len)
            continue
        x, c = dense_block(cfg, rules, p, x, positions, emit_kv=t_max)
        kv = _store(kv, (n,), (i,), c)
    if mode == "decode":
        return x, {"kv": state["kv"]}
    return x, {"kv": kv}


def _ssm_stack(cfg, rules, params, x, positions, aux, mode, state, t_max,
               cache_len, seen_len):
    blocks, n = params["ssm_blocks"], cfg.num_layers
    if mode == "train":
        body = _maybe_remat(cfg, lambda h, p: ssm_block(cfg, rules, p, h)[0],
                            True)
        for i in range(n):
            x = body(x, _at(blocks, i))
        return x, None
    caches = None
    for i in range(n):
        p = _at(blocks, i)
        if mode == "decode":
            x, _ = ssm_block(cfg, rules, p, x, cache=_at(state["ssm"], i))
        else:
            x, c = ssm_block_prefill(cfg, rules, p, x)
            caches = _store(caches, (n,), (i,), c)
    if mode == "decode":
        return x, {"ssm": state["ssm"]}
    return x, {"ssm": caches}


def _hybrid_stack(cfg, rules, params, x, positions, aux, mode, state, t_max,
                  cache_len, seen_len):
    groups, per = cfg.scan_groups()
    blocks, shared = params["ssm_blocks"], params["shared"]
    if mode == "train":
        def group(h, pg, ps):
            for i in range(per):
                h, _ = ssm_block(cfg, rules, _at(pg, i), h)
            return dense_block(cfg, rules, ps, h, positions)[0]

        body = _maybe_remat(cfg, group, True)
        for g in range(groups):
            x = body(x, _at(blocks, g), shared)
        return x, None
    ssm_c = kv_c = None
    for g in range(groups):
        for i in range(per):
            p = _at(blocks, g, i)
            if mode == "decode":
                x, _ = ssm_block(cfg, rules, p, x,
                                 cache=_at(state["ssm"], g, i))
            else:
                x, c = ssm_block_prefill(cfg, rules, p, x)
                ssm_c = _store(ssm_c, (groups, per), (g, i), c)
        if mode == "decode":
            x, _ = dense_block(cfg, rules, shared, x, positions,
                               cache=_at(state["kv"], g), cache_len=cache_len,
                               seen_len=seen_len)
            continue
        x, kv = dense_block(cfg, rules, shared, x, positions, emit_kv=t_max)
        kv_c = _store(kv_c, (groups,), (g,), kv)
    if mode == "decode":
        return x, {"ssm": state["ssm"], "kv": state["kv"]}
    return x, {"ssm": ssm_c, "kv": kv_c}


def _vlm_stack(cfg, rules, params, x, positions, aux, mode, state, t_max,
               cache_len, seen_len):
    groups, per = cfg.scan_groups()
    selfb, cross = params["self_blocks"], params["cross_blocks"]
    vision = aux.vision
    if mode == "train":
        def group(h, pg, pc):
            for i in range(per - 1):
                h, _ = dense_block(cfg, rules, _at(pg, i), h, positions)
            return xattn_block(cfg, rules, pc, h, vision)

        body = _maybe_remat(cfg, group, True)
        for g in range(groups):
            x = body(x, _at(selfb, g), _at(cross, g))
        return x, None
    kv_c = None
    for g in range(groups):
        for i in range(per - 1):
            p = _at(selfb, g, i)
            if mode == "decode":
                x, _ = dense_block(cfg, rules, p, x, positions,
                                   cache=_at(state["kv"], g, i),
                                   cache_len=cache_len, seen_len=seen_len)
            else:
                x, kv = dense_block(cfg, rules, p, x, positions,
                                    emit_kv=t_max)
                kv_c = _store(kv_c, (groups, per - 1), (g, i), kv)
        x = xattn_block(cfg, rules, _at(cross, g), x, vision)
    if mode == "decode":
        return x, {"kv": state["kv"]}
    return x, {"kv": kv_c}


def _encdec_block(cfg, rules, p, x, positions, memory, **kw):
    """One decoder layer: causal self-attention, cross-attention onto the
    encoder's memory, MLP."""
    h, kv = attn.self_attention(cfg, rules, p["attn"],
                                rmsnorm(x, p["ln1"], cfg.norm_eps), positions,
                                **kw)
    x = x + h
    x = x + attn.cross_attention(cfg, rules, p["xattn"],
                                 rmsnorm(x, p["lnx"], cfg.norm_eps), memory)
    x = x + mlp(cfg, rules, p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, kv


def _encdec_stack(cfg, rules, params, x, positions, aux, mode, state, t_max,
                  cache_len, seen_len):
    blocks, n = params["dec_blocks"], cfg.num_layers
    memory = aux.memory
    if mode == "train":
        body = _maybe_remat(
            cfg, lambda h, p: _encdec_block(cfg, rules, p, h, positions,
                                            memory)[0], True)
        for i in range(n):
            x = body(x, _at(blocks, i))
        return x, None
    kv = None
    for i in range(n):
        p = _at(blocks, i)
        if mode == "decode":
            x, _ = _encdec_block(cfg, rules, p, x, positions, memory,
                                 cache=_at(state["kv"], i),
                                 cache_len=cache_len, seen_len=seen_len)
        else:
            x, c = _encdec_block(cfg, rules, p, x, positions, memory,
                                 emit_kv=t_max)
            kv = _store(kv, (n,), (i,), c)
    if mode == "decode":
        return x, {"kv": state["kv"]}
    return x, {"kv": kv}


def encoder_stack(cfg: ModelConfig, rules, params, frames):
    """Bidirectional encoder over precomputed frame embeddings [B, Sf, D]:
    non-causal self-attention (the plain ``attend``, never the flash
    kernel), no remat, as in the reference."""
    positions = torch.arange(frames.shape[1], dtype=torch.int32,
                             device=frames.device)[None, :]
    positions = positions.expand(frames.shape[:2])
    x = frames
    for i in range(cfg.encoder_layers):
        p = _at(params["blocks"], i)
        h, _ = attn.self_attention(cfg, rules, p["attn"],
                                   rmsnorm(x, p["ln1"], cfg.norm_eps),
                                   positions, is_causal=False)
        x = x + h
        x = x + mlp(cfg, rules, p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    return rmsnorm(x, params["norm"], cfg.norm_eps)
