"""Block composition: dense / SSM / hybrid stacks (the port of
``repro/models/transformer.py``).

Parameters keep the reference's stacked layout (a leading layer axis, or
[groups, per] for the Zamba2 hybrid), so converted parameters match leaf
for leaf; where the reference scans over that axis, the port loops in
Python. Three execution modes share the block math:
  train    — no caches (``models.forward``)
  prefill  — same math, additionally emits KV/SSM caches, stacked
  decode   — single token, caches updated in place

MoE, VLM cross-attention and encoder-decoder stacks are not ported yet
(ROADMAP Queue 1) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.specs import ShardingRules
from . import attention as attn
from . import ssm as ssm_mod
from .layers import mlp, mlp_defs, rmsnorm
from .params import ParamDef


def _not_ported(cfg: ModelConfig) -> None:
    kind = ("MoE" if cfg.moe is not None else "VLM cross-attention"
            if cfg.is_vlm else "encoder-decoder" if cfg.is_enc_dec else None)
    if kind is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {kind} stack is not ported yet (ROADMAP "
            "Queue 1)"
        )


# ------------------------------------------------------------ param defs
def dense_block_defs(cfg: ModelConfig, lead=()) -> dict:
    ll = tuple(["layers"] * len(lead))
    return {
        "ln1": ParamDef(lead + (cfg.d_model,), ll + (None,), init="ones"),
        "attn": attn.attn_defs(cfg, lead),
        "ln2": ParamDef(lead + (cfg.d_model,), ll + (None,), init="ones"),
        "ffn": mlp_defs(cfg, lead),
    }


def ssm_block_defs(cfg: ModelConfig, lead=()) -> dict:
    ll = tuple(["layers"] * len(lead))
    return {
        "ln1": ParamDef(lead + (cfg.d_model,), ll + (None,), init="ones"),
        "ssm": ssm_mod.ssm_defs(cfg, lead),
    }


def stack_defs(cfg: ModelConfig) -> dict:
    """Parameter defs for the decoder stack of ``cfg``."""
    _not_ported(cfg)
    groups, per = cfg.scan_groups()
    if cfg.is_hybrid:
        return {
            "ssm_blocks": ssm_block_defs(cfg, lead=(groups, per)),
            "shared": dense_block_defs(cfg),  # ONE shared block (Zamba2)
        }
    if cfg.is_ssm:
        return {"ssm_blocks": ssm_block_defs(cfg, lead=(cfg.num_layers,))}
    return {"blocks": dense_block_defs(cfg, lead=(cfg.num_layers,))}


# ------------------------------------------------------------ block bodies
def dense_block(cfg, rules, p, x, positions, *, cache=None, cache_len=None,
                seen_len=None, emit_kv=None):
    h, new_cache = attn.self_attention(
        cfg, rules, p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), positions,
        cache=cache, cache_len=cache_len, seen_len=seen_len, emit_kv=emit_kv,
    )
    x = x + h
    x = x + mlp(cfg, rules, p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps))
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


# -------------------------------------------------------------- the stacks
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
    _not_ported(cfg)
    args = (cfg, rules, params, x, positions, mode, state, t_max, cache_len,
            seen_len)
    if cfg.is_hybrid:
        return _hybrid_stack(*args)
    if cfg.is_ssm:
        return _ssm_stack(*args)
    return _dense_stack(*args)


def _dense_stack(cfg, rules, params, x, positions, mode, state, t_max,
                 cache_len, seen_len):
    blocks, n = params["blocks"], cfg.num_layers
    kv = None
    for i in range(n):
        p = _at(blocks, i)
        if mode == "decode":
            x, _ = dense_block(cfg, rules, p, x, positions,
                               cache=_at(state["kv"], i), cache_len=cache_len,
                               seen_len=seen_len)
            continue
        x, c = dense_block(cfg, rules, p, x, positions,
                           emit_kv=t_max if mode == "prefill" else None)
        if mode == "prefill":
            kv = _store(kv, (n,), (i,), c)
    if mode == "decode":
        return x, {"kv": state["kv"]}
    return x, ({"kv": kv} if mode == "prefill" else None)


def _ssm_stack(cfg, rules, params, x, positions, mode, state, t_max,
               cache_len, seen_len):
    blocks, n = params["ssm_blocks"], cfg.num_layers
    caches = None
    for i in range(n):
        p = _at(blocks, i)
        if mode == "decode":
            x, _ = ssm_block(cfg, rules, p, x, cache=_at(state["ssm"], i))
        elif mode == "prefill":
            x, c = ssm_block_prefill(cfg, rules, p, x)
            caches = _store(caches, (n,), (i,), c)
        else:
            x, _ = ssm_block(cfg, rules, p, x)
    if mode == "decode":
        return x, {"ssm": state["ssm"]}
    return x, ({"ssm": caches} if mode == "prefill" else None)


def _hybrid_stack(cfg, rules, params, x, positions, mode, state, t_max,
                  cache_len, seen_len):
    groups, per = cfg.scan_groups()
    blocks, shared = params["ssm_blocks"], params["shared"]
    ssm_c = kv_c = None
    for g in range(groups):
        for i in range(per):
            p = _at(blocks, g, i)
            if mode == "decode":
                x, _ = ssm_block(cfg, rules, p, x,
                                 cache=_at(state["ssm"], g, i))
            elif mode == "prefill":
                x, c = ssm_block_prefill(cfg, rules, p, x)
                ssm_c = _store(ssm_c, (groups, per), (g, i), c)
            else:
                x, _ = ssm_block(cfg, rules, p, x)
        if mode == "decode":
            x, _ = dense_block(cfg, rules, shared, x, positions,
                               cache=_at(state["kv"], g), cache_len=cache_len,
                               seen_len=seen_len)
            continue
        x, kv = dense_block(cfg, rules, shared, x, positions,
                            emit_kv=t_max if mode == "prefill" else None)
        if mode == "prefill":
            kv_c = _store(kv_c, (groups,), (g,), kv)
    if mode == "decode":
        return x, {"ssm": state["ssm"], "kv": state["kv"]}
    return x, ({"ssm": ssm_c, "kv": kv_c} if mode == "prefill" else None)
