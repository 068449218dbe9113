"""Attention: GQA/MHA, causal + sliding-window masks, cross-attention, KV
caches for decode (the port of ``repro/models/attention.py``). Reference
einsum path everywhere; the port's flash kernel (``repro_torch.kernels.
flash_attention``) is switched in for causal self-attention without a cache
(forward and prefill) when ``cfg.use_pallas`` is set. Cross-attention and
the encoder's non-causal self-attention never take it, as in the
reference.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.specs import (
    ShardingRules,
    current_mesh,
    is_dtensor,
    kernel_split,
    local_call,
    mesh_axis_sizes,
    replicate_like,
    shard_constraint,
    shard_offset,
    shards_of,
    unshard,
)
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
def _scores_split(h: int, sq: int, rules: ShardingRules | None):
    """The port of the reference's ``_scores_constraint``: how the
    [B,H,Sq,Sk] score buffer is cut over the TP axis of the current mesh.
    Heads are preferred; when the head count doesn't divide the axis
    (qwen2: 28H, smollm: 9H), query rows, so that the O(S^2) buffer never
    replicates. Returns (axis, "heads" or "rows"), or None (no mesh, no
    TP axis, or neither dim divides)."""
    mesh = current_mesh()
    if mesh is None or rules is None:
        return None
    tp = rules.filter_for_mesh(mesh).tp
    if tp is None:
        return None
    axis = tp if isinstance(tp, str) else tp[0]
    size = mesh_axis_sizes(mesh).get(axis, 1)
    if h % size == 0:
        return axis, "heads"
    if sq % size == 0:
        return axis, "rows"
    return None


def _attend_local(q, k, v, mask, rules, fn):
    """``fn(q, k, v, mask=mask)``, the plain attention, on DTensors as local
    shards laid out as ``_scores_split`` cuts the score buffer:
    batch rows keep their shards, and the TP axis cuts heads (where the kv
    heads divide too, so that a shard holds whole GQA groups) or else query
    rows (k and v whole there, the mask's rows cut alike); everything else
    is gathered. DTensor's own einsums here flatten sharded dims, which its
    view rules refuse."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, rep = q.device_mesh, Replicate()
    b, sq, h, _ = q.shape
    kvh = k.shape[2]
    split = _scores_split(h, sq, rules)
    tp_dim = (list(mesh.mesh_dim_names or ()).index(split[0])
              if split is not None else None)
    if mask is not None:
        mask = replicate_like(mask, q)

    def cut(d: int):  # the mask's dim d cut where it is not broadcast
        return Shard(d) if mask is not None and mask.shape[d] > 1 else rep

    roles = []  # per mesh axis: q, k and v, mask, out, k's and v's grads
    for i, pl in enumerate(q.placements):
        n = mesh.size(i)
        if isinstance(pl, Shard) and pl.dim == 0:
            roles.append((pl, pl, cut(0), pl, pl))
        elif i == tp_dim and h % n == 0 and kvh % n == 0:
            roles.append((Shard(2), Shard(2), cut(1), Shard(2), Shard(2)))
        elif i == tp_dim and sq % n == 0:
            roles.append((Shard(1), rep, cut(2), Shard(1), Partial()))
        else:
            roles.append((rep,) * 5)
    qp, kp, mp, op, kg = zip(*roles)
    return local_call(
        lambda ql, kl, vl, ml: fn(ql, kl, vl, mask=ml), (q, k, v, mask),
        (qp, kp, kp, None if mask is None else mp), op,
        tuple(q.shape[:3]) + (v.shape[-1],), (qp, kg, kg, mp))


def _flash(q, k, v, **kw):
    """The flash kernel on q [B,S,H,D], k/v [B,S,Kv,D]. DTensors cross to
    the kernel as local shards where ``kernel_split`` says a shard
    computes the same function (batch rows, whole GQA groups of heads);
    every other placement is gathered first."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    if not is_dtensor(q):
        return flash_attention(q, k, v, **kw)
    from torch.distributed.tensor import Replicate, Shard

    to = {"batch": Shard(0), "heads": Shard(2), None: Replicate()}
    place = [to[r] for r in kernel_split(q, q.shape[2], k.shape[2])]
    return local_call(functools.partial(flash_attention, **kw), (q, k, v),
                      (place,) * 3, place, q.shape)


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
    max in f32, sums in f32). DTensors attend as local shards
    (``_attend_local``)."""
    if is_dtensor(q):
        return _attend_local(q, k, v, mask, rules, functools.partial(
            attend, q_per_kv=q_per_kv, scale=scale, scores_bf16=scores_bf16))
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


def _local_product(eq: str, a, b, roles: list, shape: tuple):
    """``einsum(eq, a, b)`` of two DTensors as a product of local shards.
    ``roles`` holds, per mesh axis, the placements of a, b and the product,
    then those of a's and b's gradients."""
    ap, bp, yp, ag, bg = zip(*roles)
    return local_call(functools.partial(torch.einsum, eq), (a, b), (ap, bp),
                      yp, shape, (ag, bg))


def _project(x, w):
    """x [B,S,D] @ w [D,H,E] -> [B,S,H,E] (the einsum "bsd,dhe->bshe").
    DTensors are multiplied as local shards, as Megatron's column-parallel
    layer does: x keeps its batch and sequence shards, w its head shards
    on the other mesh axes, and everything else is gathered (w's fsdp
    shards too). DTensor's own einsum may shard the flattened H*E columns
    of the product, in the forward or the backward pass, and then cannot
    split them into heads that the shards cut."""
    if not is_dtensor(x):
        return torch.einsum("bsd,dhe->bshe", x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard

    rep, roles = Replicate(), []
    for pl_x, pl_w in zip(x.placements, w.placements):
        if isinstance(pl_x, Shard) and pl_x.dim in (0, 1):  # rows
            roles.append((pl_x, rep, pl_x, pl_x, Partial()))
        elif pl_w == Shard(1):  # heads
            roles.append((rep, pl_w, Shard(2), Partial(), pl_w))
        else:
            roles.append((rep,) * 5)
    return _local_product("bsd,dhe->bshe", x, w, roles,
                          tuple(x.shape[:2]) + tuple(w.shape[1:]))


def _unproject(o, w):
    """o [B,S,H,E] @ w [H,E,D] -> [B,S,D] (the einsum "bshe,hed->bsd"),
    for DTensors as local shards as ``_project`` does (row-parallel: o's
    head shards meet w's, and their product is a partial sum)."""
    if not is_dtensor(o):
        return torch.einsum("bshe,hed->bsd", o, w)
    from torch.distributed.tensor import Partial, Replicate, Shard

    rep, roles = Replicate(), []
    whole_heads = o.shape[2] % shards_of(o, 2) == 0
    for pl in o.placements:
        if isinstance(pl, Shard) and pl.dim in (0, 1):  # rows
            roles.append((pl, rep, pl, pl, Partial()))
        elif pl == Shard(2) and whole_heads:
            roles.append((pl, Shard(0), Partial(), pl, Shard(0)))
        else:
            roles.append((rep,) * 5)
    return _local_product("bshe,hed->bsd", o, w, roles,
                          tuple(o.shape[:2]) + (w.shape[-1],))


# ----------------------------------------------------------------- full layer
def _pad_seq(x, t_max: int):
    """[B,S,...] -> [B,t_max,...] zero-padded."""
    s = x.shape[1]
    if s == t_max:
        return x
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, t_max - s))


def _write_slot(cache, slot, new) -> None:
    """cache [B,T,Kv,Dh][:, slot] = new [B,1,Kv,Dh], in place. A DTensor
    cache is written through its local shard, ``new`` first brought to
    the cache's placements but whole over T. Where mesh axes shard T
    (context parallelism), each rank holds T's rows from its
    ``shard_offset`` on and writes the slot only if it falls there: the
    local slot clamped into range and the old row kept where it does not,
    with no host read of the slot (the reference's dynamic-update-slice
    under GSPMD)."""
    idx = (unshard(slot).to_local() if is_dtensor(slot) else slot)
    idx = idx.reshape(1).long()

    def write(c, n):
        return c.index_copy_(1, idx, n)

    new = new.to(cache.dtype)
    if not is_dtensor(cache):
        write(cache, new)
        return
    if shards_of(cache, 1) == 1:
        local_call(write, (cache, new), (cache.placements,) * 2,
                   cache.placements, cache.shape)
        return
    from torch.distributed.tensor import Replicate, Shard

    offset = shard_offset(cache, 1)

    def write_if_here(c, n):
        at = idx - offset
        inside = ((at >= 0) & (at < c.shape[1])).reshape(1, 1, 1, 1)
        at = at.clamp(0, c.shape[1] - 1)
        return c.index_copy_(1, at, torch.where(inside, n,
                                                c.index_select(1, at)))

    whole_t = tuple(Replicate() if pl == Shard(1) else pl
                    for pl in cache.placements)
    local_call(write_if_here, (cache, new), (cache.placements, whole_t),
               cache.placements, cache.shape)


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
    q = _project(x, p["wq"].to(dt))
    k = _project(x, p["wk"].to(dt))
    v = _project(x, p["wv"].to(dt))
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
            out = _flash(q, k, v, causal=True, window=cfg.sliding_window,
                         scale=scale)
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
        seen = torch.as_tensor(cache_len if seen_len is None else seen_len,
                               device=x.device)
        slot = torch.as_tensor(cache_len, device=x.device)
        _write_slot(ck, slot, k)
        _write_slot(cv, slot, v)
        ki = replicate_like(torch.arange(T, device=x.device)[None, :], seen)
        valid = ki <= torch.clamp(seen, max=T - 1)
        mask = valid[None, None]  # [1,1,1(Sq),T]
        out = attend(q, ck, cv, q_per_kv=cfg.q_per_kv, mask=mask, scale=scale,
                     rules=rules, scores_bf16=cfg.attn_scores_bf16)
        new_cache = {"k": ck, "v": cv}

    out = _unproject(out, p["wo"].to(dt))
    out = shard_constraint(out, rules, "batch", "seq", None)
    return out, new_cache


def cross_attention(cfg: ModelConfig, rules: ShardingRules, p: dict, x,
                    kv_src):
    """Cross-attention from x [B,S,D] onto kv_src [B,Skv,D] (no RoPE, no mask;
    VLM image tokens / enc-dec memory). Always the plain ``attend``, as in
    the reference: the flash kernel takes causal self-attention only."""
    dt = x.dtype
    dh = cfg.resolved_head_dim
    q = _project(x, p["wq"].to(dt))
    k = _project(kv_src, p["wk"].to(dt))
    v = _project(kv_src, p["wv"].to(dt))
    out = attend(q, k, v, q_per_kv=cfg.q_per_kv, mask=None, scale=dh ** -0.5,
                 rules=rules, scores_bf16=cfg.attn_scores_bf16)
    out = _unproject(out, p["wo"].to(dt))
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
