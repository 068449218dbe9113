"""Attention: GQA/MHA, causal + sliding-window masks, cross-attention, KV
caches for decode (the port of ``repro/models/attention.py``). Reference
einsum path everywhere; the port's flash kernel (``repro_torch.kernels.
flash_attention``) is switched in for causal self-attention without a cache
(forward and prefill) when ``cfg.use_pallas`` is set. Cross-attention and
the encoder's non-causal self-attention never take it, as in the
reference.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.specs import ShardingRules, shard_constraint
from .layers import rope
from .params import ParamDef

NEG_INF = -1e30


# ----------------------------------------------------------------- param defs
def attn_defs(
    cfg: ModelConfig, lead: tuple[int, ...] = (), cross: bool = False
) -> dict:
    d = cfg.d_model
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ll = tuple(["layers"] * len(lead))
    defs = {
        "wq": ParamDef(lead + (d, h, dh), ll + ("fsdp", "tp", None), fan_in=d),
        "wk": ParamDef(lead + (d, kv, dh), ll + ("fsdp", "tp", None), fan_in=d),
        "wv": ParamDef(lead + (d, kv, dh), ll + ("fsdp", "tp", None), fan_in=d),
        "wo": ParamDef(lead + (h, dh, d), ll + ("tp", None, "fsdp"),
                       fan_in=h * dh),
    }
    if cfg.qkv_bias and not cross:
        defs["bq"] = ParamDef(lead + (h, dh), ll + ("tp", None), init="zeros")
        defs["bk"] = ParamDef(lead + (kv, dh), ll + ("tp", None), init="zeros")
        defs["bv"] = ParamDef(lead + (kv, dh), ll + ("tp", None), init="zeros")
    return defs


# ------------------------------------------------------------------ core math
def _scores_constraint(scores, rules: ShardingRules):
    """No mesh on one device: the [B,H,Sq,Sk] buffer as it is."""
    return scores


def _gqa_scores(q, k, q_per_kv, acc_dtype=torch.float32):
    """q: [B,Sq,H,Dh], k: [B,Sk,Kv,Dh] -> [B,H,Sq,Sk] (flat heads), the
    products summed in ``acc_dtype``."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    q = q.reshape(b, sq, kvh, q_per_kv, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(acc_dtype), k.to(acc_dtype))
    return s.reshape(b, h, sq, k.shape[1])


def _gqa_combine(w, v, q_per_kv):
    """w: [B,H,Sq,Sk] f32, v: [B,Sk,Kv,Dh] -> [B,Sq,H,Dh]."""
    b, h, sq, sk = w.shape
    kvh = v.shape[2]
    w = w.reshape(b, kvh, q_per_kv, sq, sk)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)
    return out.reshape(b, sq, h, v.shape[-1])


def attend(q, k, v, *, q_per_kv: int, mask=None, scale: float,
           rules: ShardingRules | None = None, scores_bf16: bool = False):
    """Masked GQA attention. mask: broadcastable [B|1,H|1,Sq,Sk] with True =
    attend. scores_bf16: keep the O(S^2) score/weight buffers in bf16 (row
    max in f32, sums in f32)."""
    if scores_bf16:
        bf16 = torch.bfloat16
        scores = _gqa_scores(q, k, q_per_kv, acc_dtype=bf16)
        scores = scores * torch.tensor(scale, dtype=bf16)
        if mask is not None:
            scores = torch.where(mask, scores,
                                 torch.tensor(-3e38, dtype=bf16))
        m = torch.amax(scores.float(), dim=-1, keepdim=True)
        p = torch.exp(scores - m.to(bf16))
        denom = torch.sum(p.float(), dim=-1, keepdim=True)
        w = p / torch.clamp(denom, min=1e-20).to(bf16)
        return _gqa_combine(w, v, q_per_kv)
    scores = _gqa_scores(q, k, q_per_kv) * scale
    if rules is not None:
        scores = _scores_constraint(scores, rules)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return _gqa_combine(w, v, q_per_kv)


def causal_mask(sq: int, sk: int, *, window: int | None, q_offset=0,
                device=None):
    """[1,1,Sq,Sk] boolean; window = sliding-window width if any."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m[None, None]


# ----------------------------------------------------------------- full layer
def _pad_seq(x, t_max: int):
    """[B,S,...] -> [B,t_max,...] zero-padded."""
    s = x.shape[1]
    if s == t_max:
        return x
    out = x.new_zeros((x.shape[0], t_max) + tuple(x.shape[2:]))
    out[:, :s] = x
    return out


def self_attention(
    cfg: ModelConfig,
    rules: ShardingRules,
    p: dict,
    x,
    positions,
    *,
    cache: dict | None = None,
    cache_len=None,  # decode: slot to write (wrapped for SWA ring buffers)
    seen_len=None,  # decode: total tokens seen (mask horizon); default slot
    emit_kv: int | None = None,  # prefill: emit {'k','v'} padded to this len
    is_causal: bool = True,
):
    """x: [B,S,D]. Forward/prefill when cache is None; single-step decode
    when cache={'k','v'} ([B,T,Kv,Dh]) and cache_len = write slot (a 0-d
    integer tensor). Decode writes the new k/v into the cache tensors IN
    PLACE (no copy of the [B,T,Kv,Dh] buffers) and returns them."""
    dt = x.dtype
    dh = cfg.resolved_head_dim
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = shard_constraint(q, rules, "batch", "seq", "tp", None)
    k = shard_constraint(k, rules, "batch", "seq", "tp", None)
    scale = dh ** -0.5

    if cache is None:
        if cfg.use_pallas and is_causal:
            from repro_torch.kernels.flash_attention.ops import flash_attention

            out = flash_attention(
                q, k, v, causal=True, window=cfg.sliding_window, scale=scale
            )
        else:
            mask = (
                causal_mask(q.shape[1], k.shape[1], window=cfg.sliding_window,
                            device=x.device)
                if is_causal
                else None
            )
            out = attend(q, k, v, q_per_kv=cfg.q_per_kv, mask=mask,
                         scale=scale, rules=rules,
                         scores_bf16=cfg.attn_scores_bf16)
        new_cache = None
        if emit_kv is not None:
            new_cache = {"k": _pad_seq(k, emit_kv), "v": _pad_seq(v, emit_kv)}
    else:
        # decode: write k/v at slot cache_len, attend over everything seen.
        # For SWA the buffer IS the window (a ring), so once full every slot
        # is valid; attention is permutation-invariant over keys and RoPE was
        # applied at write time, so ring order is immaterial.
        ck, cv = cache["k"], cache["v"]
        T = ck.shape[1]
        seen = cache_len if seen_len is None else seen_len
        slot = torch.as_tensor(cache_len, device=x.device).reshape(1).long()
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        ki = torch.arange(T, device=x.device)[None, :]
        valid = ki <= torch.clamp(torch.as_tensor(seen, device=x.device),
                                  max=T - 1)
        mask = valid[None, None]  # [1,1,1(Sq),T]
        out = attend(q, ck, cv, q_per_kv=cfg.q_per_kv, mask=mask, scale=scale,
                     rules=rules, scores_bf16=cfg.attn_scores_bf16)
        new_cache = {"k": ck, "v": cv}

    out = torch.einsum("bshe,hed->bsd", out, p["wo"].to(dt))
    out = shard_constraint(out, rules, "batch", "seq", None)
    return out, new_cache


def cross_attention(cfg: ModelConfig, rules: ShardingRules, p: dict, x,
                    kv_src):
    """Cross-attention from x [B,S,D] onto kv_src [B,Skv,D] (no RoPE, no mask;
    VLM image tokens / enc-dec memory). Always the plain ``attend``, as in
    the reference: the flash kernel takes causal self-attention only."""
    dt = x.dtype
    dh = cfg.resolved_head_dim
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", kv_src, p["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", kv_src, p["wv"].to(dt))
    out = attend(q, k, v, q_per_kv=cfg.q_per_kv, mask=None, scale=dh ** -0.5,
                 rules=rules, scores_bf16=cfg.attn_scores_bf16)
    out = torch.einsum("bshe,hed->bsd", out, p["wo"].to(dt))
    return shard_constraint(out, rules, "batch", "seq", None)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype, device=None):
    """Stacked KV cache [n_layers, B, T, Kv, Dh]."""
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (n_layers, batch, max_len, kv, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_logical() -> dict:
    return {"k": ("layers", "batch", "seq", "tp", None),
            "v": ("layers", "batch", "seq", "tp", None)}
