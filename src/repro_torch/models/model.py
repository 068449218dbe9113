"""Top-level model API: params, forward, loss, prefill, decode (the port of
``repro/models/model.py``).

``batch`` dict convention:
  tokens  [B, S] integer   — decoder token ids (always present)
  labels  [B, S] integer   — next-token targets (train)
  vision  [B, Sv, D] f     — precomputed patch embeddings (VLM stub frontend)
  frames  [B, Sf, D] f     — precomputed audio frame embeddings (audio stub)

Decode state convention (threaded through serve_step):
  {"pos": 0-d int32 tensor, "kv": {...}, "ssm": {...}, "memory"/"vision":
  [...]}
``decode_step`` updates the state's caches IN PLACE: the KV buffers and SSM
states are the largest tensors of serving, and a copy per token would
double them. The caller's state dict is left with the new caches and the
returned state shares them.

``prefill`` and ``decode_step`` run under ``torch.inference_mode()``: no
gradient. ``forward`` and ``loss_fn`` record the autograd graph where the
parameters require grad (training); with ``cfg.use_pallas`` they then
raise, since the CUDA kernels have no backward (nor do the reference's
Pallas kernels).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.sharding.specs import ShardingRules
from repro_torch.tree import leaves
from . import params as P
from .layers import embed, embed_defs, rmsnorm, rmsnorm_def, unembed_matrix
from .transformer import Aux, encoder_defs, encoder_stack, run_stack, stack_defs


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ------------------------------------------------------------------ params
def abstract_params(cfg: ModelConfig) -> dict:
    tree = {
        "embed": embed_defs(cfg),
        "decoder": stack_defs(cfg),
        "final_norm": rmsnorm_def(cfg.d_model),
    }
    if cfg.is_enc_dec:
        tree["encoder"] = encoder_defs(cfg)
    return tree


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Parameters drawn from ``generator``, on ``device`` (the card unless
    the caller names another; raises with no card and no device)."""
    with torch.no_grad():
        return P.materialize(abstract_params(cfg), generator, device)


def param_logical(cfg: ModelConfig) -> dict:
    return P.logical_specs(abstract_params(cfg))


def param_shape_dtypes(cfg: ModelConfig) -> dict:
    """Meta tensors of every parameter's shape and type (no storage)."""
    return P.shape_dtypes(abstract_params(cfg))


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total parameters; with ``active_only`` an MoE model counts top_k of
    its num_experts experts."""
    tree = abstract_params(cfg)
    total = P.count(tree)
    if not (active_only and cfg.moe):
        return total
    expert = sum(int(np.prod(pd.shape)) for _, pd in leaves(tree)
                 if "expert" in pd.logical)
    active = expert * cfg.moe.top_k / cfg.moe.num_experts
    return int(total - expert + active)


# ----------------------------------------------------------------- forward
def _positions(tokens):
    s = tokens.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :]
    return pos.expand(tokens.shape)


def _aux(cfg: ModelConfig, rules: ShardingRules, params, batch) -> Aux:
    memory = None
    vision = None
    if cfg.is_enc_dec:
        memory = encoder_stack(
            cfg, rules, params["encoder"], batch["frames"].to(_dtype(cfg))
        )
    if cfg.is_vlm:
        vision = batch["vision"].to(_dtype(cfg))
    return Aux(memory=memory, vision=vision)


def forward(cfg: ModelConfig, rules: ShardingRules, params, batch):
    """Train-mode forward to the final norm. Returns hidden [B, S, D]."""
    dt = _dtype(cfg)
    x = embed(cfg, rules, params["embed"], batch["tokens"], dt)
    aux = _aux(cfg, rules, params, batch)
    h, _ = run_stack(cfg, rules, params["decoder"], x,
                     _positions(batch["tokens"]), aux, mode="train")
    return rmsnorm(h, params["final_norm"], cfg.norm_eps)


def logits_of(cfg: ModelConfig, params, h):
    """f32 logits of hidden rows h [..., D] against the unembedding in the
    activation type (products summed in f32)."""
    w = unembed_matrix(cfg, params["embed"], _dtype(cfg))
    return h.float() @ w.float()


def loss_fn(cfg: ModelConfig, rules: ShardingRules, params, batch):
    """Sequence-chunked cross entropy (keeps the [*, V] logits buffer small):
    a loop over chunks of ``cfg.loss_chunk`` positions where the reference
    scans. Returns (loss, metrics)."""
    h = forward(cfg, rules, params, batch)
    labels = batch["labels"].long()
    b, s, _ = h.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of loss chunk {c}")
    # f32 products of activation-type values, as the reference's
    # preferred_element_type=float32
    w = unembed_matrix(cfg, params["embed"], h.dtype).float()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, c):
        logits = h[:, i:i + c].float() @ w  # [B, c, V]
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, i:i + c, None])[..., 0]
        total = total + torch.sum(lse - gold)
    loss = total / (b * s)
    return loss, {"loss": loss,
                  "tokens": torch.tensor(b * s, dtype=torch.float32)}


# ------------------------------------------------------------------ serving
def _attn_cache_layers(cfg: ModelConfig) -> tuple[int, ...]:
    """Leading stack dims of the KV cache for this family."""
    groups, per = cfg.scan_groups()
    if cfg.is_hybrid:
        return (groups,)
    if cfg.is_ssm:
        return ()
    if cfg.is_vlm:
        return (groups, per - 1)
    return (cfg.num_layers,)


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int, *,
                      dtype=None, batch_extras: dict | None = None,
                      device=None) -> dict:
    """Zero caches sized for a context of ``seq_len`` tokens, on ``device``
    (the card unless the caller names another; ``"meta"`` allocates
    nothing). ``memory`` holds ``batch_extras["frames"]`` as given (the raw
    frames, not the encoder's output, as the reference's does; ``prefill``
    stores the encoder's output) and ``vision`` the vision tokens, each
    zeros when absent."""
    device = resolve_device(device)
    dt = dtype or _dtype(cfg)
    state: dict = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    lead = _attn_cache_layers(cfg)
    if lead:
        kv_len = seq_len
        if cfg.sliding_window is not None:
            kv_len = min(seq_len, cfg.sliding_window)  # SWA ring buffer
        kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
        shape = lead + (batch, kv_len, kv, dh)
        state["kv"] = {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.ssm is not None:
        groups, per = cfg.scan_groups()
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        heads = d_inner // s.head_dim
        conv_dim = d_inner + 2 * s.d_state
        ssm_lead = (groups, per) if cfg.is_hybrid else (cfg.num_layers,)
        state["ssm"] = {
            "conv": torch.zeros(ssm_lead + (batch, s.d_conv - 1, conv_dim),
                                dtype=dt, device=device),
            "state": torch.zeros(
                ssm_lead + (batch, heads, s.head_dim, s.d_state), dtype=dt,
                device=device),
        }
    extras = batch_extras or {}
    if cfg.is_enc_dec:
        frames = extras.get("frames")
        state["memory"] = (
            frames if frames is not None
            else torch.zeros((batch, cfg.num_frames, cfg.d_model), dtype=dt,
                             device=device)
        )
    if cfg.is_vlm:
        vision = extras.get("vision")
        state["vision"] = (
            vision if vision is not None
            else torch.zeros((batch, cfg.num_vision_tokens, cfg.d_model),
                             dtype=dt, device=device)
        )
    return state


def decode_state_logical(cfg: ModelConfig) -> dict:
    """Logical sharding axes mirroring init_decode_state's structure."""
    spec: dict = {"pos": ()}
    lead = _attn_cache_layers(cfg)
    if lead:
        ax = tuple(["layers"] * len(lead)) + ("batch", "seq", "tp", None)
        spec["kv"] = {"k": ax, "v": ax}
    if cfg.ssm is not None:
        nl = 2 if cfg.is_hybrid else 1
        ll = tuple(["layers"] * nl)
        spec["ssm"] = {
            "conv": ll + ("batch", None, "tp"),
            "state": ll + ("batch", "tp", None, None),
        }
    if cfg.is_enc_dec:
        spec["memory"] = ("batch", None, None)
    if cfg.is_vlm:
        spec["vision"] = ("batch", None, None)
    return spec


@torch.inference_mode()
def prefill(cfg: ModelConfig, rules: ShardingRules, params, batch, *,
            t_max: int | None = None):
    """Run the full prompt, build decode caches. Returns (state, last_logits)."""
    dt = _dtype(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    t_max = t_max or s
    x = embed(cfg, rules, params["embed"], tokens, dt)
    aux = _aux(cfg, rules, params, batch)
    h, caches = run_stack(cfg, rules, params["decoder"], x, _positions(tokens),
                          aux, mode="prefill", t_max=t_max)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    last_logits = logits_of(cfg, params, h[:, -1])
    state: dict = {"pos": torch.tensor(s, dtype=torch.int32,
                                       device=tokens.device)}
    state.update(caches or {})
    if cfg.is_enc_dec:
        state["memory"] = aux.memory
    if cfg.is_vlm:
        state["vision"] = aux.vision
    return state, last_logits


@torch.inference_mode()
def decode_step(cfg: ModelConfig, rules: ShardingRules, params, state,
                tokens):
    """One decode step. tokens: [B, 1] -> (logits [B, V], new state); the
    caches are updated in place (module docstring)."""
    dt = _dtype(cfg)
    pos = state["pos"]
    x = embed(cfg, rules, params["embed"], tokens, dt)
    positions = pos.reshape(1, 1).expand(tokens.shape).to(torch.int32)
    aux = Aux(memory=state.get("memory"), vision=state.get("vision"))
    cache = {k: state[k] for k in ("kv", "ssm") if k in state}
    kv_pos = pos
    if cfg.sliding_window is not None and "kv" in state:
        kv_len = state["kv"]["k"].shape[-3]
        kv_pos = pos if kv_len < cfg.sliding_window else pos % kv_len
    h, new_caches = run_stack(cfg, rules, params["decoder"], x, positions,
                              aux, mode="decode", state=cache, cache_len=kv_pos,
                              seen_len=pos)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_of(cfg, params, h[:, 0])
    new_state = dict(state)
    new_state.update(new_caches or {})
    new_state["pos"] = pos + 1
    return logits, new_state
