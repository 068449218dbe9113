"""Mamba2 mixer: the SSD (state-space duality) form, arXiv:2405.21060
(the port of ``repro/models/ssm.py``).

Forward and prefill use the chunked SSD algorithm (intra-chunk quadratic
term + inter-chunk state recurrence, a Python loop over chunks); decode
uses the O(1)-per-token recurrent update with a carried (conv window, SSD
state) cache. As in the reference, only the cache-free ``ssm_mixer``
(``models.forward``) switches to the port's SSD kernel when
``cfg.use_pallas`` is set; ``ssm_prefill_mixer`` always runs the plain
``ssd_chunked``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.specs import (ShardingRules, is_dtensor,
                                     kernel_split, local_call,
                                     replicate_like, shard_constraint)
from .layers import rmsnorm
from .params import ParamDef


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state  # x, B, C share the causal conv (G=1)
    return d_inner, heads, conv_dim


def ssm_defs(cfg: ModelConfig, lead: tuple[int, ...] = ()) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, heads, conv_dim = _dims(cfg)
    proj = 2 * d_inner + 2 * s.d_state + heads  # z, x, B, C, dt
    ll = tuple(["layers"] * len(lead))
    return {
        "in_proj": ParamDef(lead + (d, proj), ll + ("fsdp", "tp"), fan_in=d),
        "conv_w": ParamDef(lead + (s.d_conv, conv_dim), ll + (None, "tp")),
        "conv_b": ParamDef(lead + (conv_dim,), ll + ("tp",), init="zeros"),
        "a_log": ParamDef(lead + (heads,), ll + ("tp",), init="ones"),
        "d_skip": ParamDef(lead + (heads,), ll + ("tp",), init="ones"),
        "dt_bias": ParamDef(lead + (heads,), ll + ("tp",), init="zeros"),
        "norm": ParamDef(lead + (d_inner,), ll + ("tp",), init="ones"),
        "out_proj": ParamDef(lead + (d_inner, d), ll + ("tp", "fsdp"),
                             fan_in=d_inner),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    s = cfg.ssm
    d_inner, heads, _ = _dims(cfg)
    return torch.split(
        zxbcdt, [d_inner, d_inner, s.d_state, s.d_state, heads], dim=-1
    )


def _causal_conv(seq, w, b):
    """Depthwise causal conv. seq: [B,S,C], w: [K,C] -> [B,S,C]."""
    k = w.shape[0]
    pad = F.pad(seq, (0, 0, k - 1, 0))
    out = torch.zeros_like(seq)
    for i in range(k):  # k is tiny (4); unrolled taps
        out = out + pad[:, i: i + seq.shape[1], :] * w[i]
    return F.silu(out + b)


def ssd_chunked(x, dt, a, B, C, chunk: int, *, rules=None):
    """SSD scan. x:[b,S,H,P] dt:[b,S,H] a:[H](neg) B,C:[b,S,N].
    Returns y:[b,S,H,P] and final state [b,H,P,N] (in x's type).

    Ragged tails (prompt lengths off the chunk grid) are padded with dt=0 —
    zero step size leaves the recurrence invariant, so the final state is
    exact and the padded y rows are sliced off. The reference's ``unroll``
    lowering knob has no counterpart in eager PyTorch."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    S_orig = S
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
        S = S + pad
    nc = S // chunk
    f32 = torch.float32
    xr = x.reshape(b, nc, chunk, H, P)
    dtr = dt.reshape(b, nc, chunk, H)
    Br = B.reshape(b, nc, chunk, N)
    Cr = C.reshape(b, nc, chunk, N)

    dA = dtr * a  # [b,nc,Q,H], negative
    cum = torch.cumsum(dA, dim=2)  # within-chunk cumulative

    # ---- intra-chunk (quadratic within the chunk)
    # decay(i,j) = exp(cum_i - cum_j) for i >= j; exp only there: above the
    # diagonal the exponent is positive and may overflow
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,nc,i,j,H]
    ii = torch.arange(chunk, device=x.device)
    mask = replicate_like((ii[:, None] >= ii[None, :])[None, None, :, :, None],
                          x)
    decay = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", Cr.to(f32), Br.to(f32))
    scores = cb[..., None] * decay * dtr[:, :, None, :, :]  # [b,nc,i,j,H]
    if rules is not None:
        scores = shard_constraint(scores, rules, "batch", None, None, None,
                                  "tp")
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores.to(x.dtype), xr)

    # ---- inter-chunk state recurrence (f32: long products of decays)
    seg_end = cum[:, :, -1:, :]  # [b,nc,1,H]
    w_end = torch.exp(seg_end - cum) * dtr  # decay from j to chunk end
    s_chunk = torch.einsum(
        "bcjh,bcjhp,bcjn->bchpn", w_end, xr.to(f32), Br.to(f32)
    )
    chunk_decay = torch.exp(seg_end[:, :, 0, :]).to(f32)  # [b,nc,H]
    state = replicate_like(torch.zeros((b, H, P, N), dtype=f32,
                                       device=x.device), x)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    s_prev = torch.stack(s_prevs, dim=1)  # [b,nc,H,P,N]
    y_inter = torch.einsum(
        "bcin,bchpn,bcih->bcihp", Cr.to(f32), s_prev, torch.exp(cum)
    ).to(x.dtype)
    y = (y_intra + y_inter).reshape(b, S, H, P)
    if pad:
        y = y[:, :S_orig]
    return y, state.to(x.dtype)


def _ssd_local(fn, xh, dtv, a, bm, cm):
    """``fn(xh, dtv, a, bm, cm) -> (y, state)`` (the SSD kernel or the
    plain ``ssd_chunked``) on xh [B,S,H,P], dtv [B,S,H], a [H], bm/cm
    [B,S,N] -> (y [B,S,H,P], state [B,H,P,N]). DTensors cross as local
    shards where ``kernel_split`` says a shard computes the same function,
    as the flash kernel's do (B and C are shared by every head, so whole
    on a head shard, and ``a`` by every row); every other placement is
    gathered first. A whole input shared by the shards gets a partial
    gradient from each. DTensor's own einsums in ``ssd_chunked`` would
    flatten a batch sharded over two mesh axes behind the sharded heads,
    which the card's torch refuses."""
    if not is_dtensor(xh):
        return fn(xh, dtv, a, bm, cm)
    from torch.distributed.tensor import Partial, Replicate, Shard

    rep, s0, s2, part = Replicate(), Shard(0), Shard(2), Partial()
    to = {  # per mesh axis: xh, dtv, a, bm, cm, y, state
        "batch": (s0, s0, rep, s0, s0, s0, s0),
        "heads": (s2, s2, s0, rep, rep, s2, Shard(1)),
        None: (rep,) * 7,
    }
    grad = {"batch": (s0, s0, part, s0, s0),
            "heads": (s2, s2, s0, part, part), None: (rep,) * 5}
    split = kernel_split(xh, xh.shape[2])
    *ins, yp, sp = zip(*(to[r] for r in split))
    b, _, h, p = xh.shape
    return local_call(fn, (xh, dtv, a, bm, cm), ins, (yp, sp),
                      (xh.shape, (b, h, p, bm.shape[-1])),
                      grad_placements=list(zip(*(grad[r] for r in split))))


def _ssd_kernel(xh, dtv, a, bm, cm, *, chunk: int):
    """The SSD kernel through ``_ssd_local``."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    return _ssd_local(functools.partial(ssd_scan, chunk=chunk),
                      xh, dtv, a, bm, cm)


def _dense(eq: str, x, w):
    """x [B,S,K] @ w [K,N] -> [B,S,N] (the einsum ``eq``). DTensors are
    multiplied as local shards, as ``attention._project`` does: x keeps its
    batch and sequence shards, w its column shards, a K cut on both gives
    a partial sum, and everything else is gathered. DTensor's own einsum
    flattens B and S, and its backward may shard both (the gradient of
    the projection's split lands on the sequence), which the card's torch
    refuses to flatten."""
    if not is_dtensor(x):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard

    from .attention import _local_product

    rep, roles = Replicate(), []
    for pl_x, pl_w in zip(x.placements, w.placements):
        if isinstance(pl_x, Shard) and pl_x.dim in (0, 1):  # rows
            roles.append((pl_x, rep, pl_x, pl_x, Partial()))
        elif pl_w == Shard(1):  # columns
            roles.append((rep, pl_w, Shard(2), Partial(), pl_w))
        elif pl_x == Shard(2) and pl_w == Shard(0):  # the contraction
            roles.append((pl_x, pl_w, Partial(), pl_x, pl_w))
        else:
            roles.append((rep,) * 5)
    return _local_product(eq, x, w, roles, (*x.shape[:2], w.shape[1]))


def _conv_inputs(cfg: ModelConfig, p: dict, x):
    """in_proj and its split: (z, conv input [B,S,Cd], dt, a)."""
    dt_ = x.dtype
    zxbcdt = _dense("bsd,dp->bsp", x, p["in_proj"].to(dt_))
    z, xs, Bc, Cc, dt = _split_proj(cfg, zxbcdt)
    a = -torch.exp(p["a_log"].float())  # [H]
    return z, torch.cat([xs, Bc, Cc], dim=-1), dt, a


def _mix_out(cfg: ModelConfig, p: dict, y, z, dt_):
    """Gate, norm and out_proj of the SSD output y [B,S,H,P]."""
    d_inner = _dims(cfg)[0]
    y = y.reshape(*y.shape[:2], d_inner)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return _dense("bsi,id->bsd", y, p["out_proj"].to(dt_))


def _ssd_inputs(cfg: ModelConfig, p: dict, conv_in, dt):
    """Causal conv and split: (xh [B,S,H,P], B, C, dt f32 [B,S,H])."""
    s = cfg.ssm
    dt_ = conv_in.dtype
    d_inner, heads, _ = _dims(cfg)
    conv_out = _causal_conv(conv_in, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    xs, Bc, Cc = torch.split(conv_out, [d_inner, s.d_state, s.d_state], dim=-1)
    xh = xs.reshape(*xs.shape[:2], heads, s.head_dim)
    # F.softplus returns x itself above 20, where jax.nn.softplus's
    # log1p(exp(x)) differs from x by < 1e-8
    dtv = F.softplus(dt.float() + p["dt_bias"].float())
    return xh, Bc, Cc, dtv


def ssm_prefill_mixer(cfg: ModelConfig, rules: ShardingRules, p: dict, x):
    """Prefill: chunked SSD forward (always the plain ``ssd_chunked``) that
    also emits the decode cache ({'conv': [B,K-1,Cd], 'state': [B,H,P,N]})."""
    s = cfg.ssm
    dt_ = x.dtype
    z, conv_in, dt, a = _conv_inputs(cfg, p, x)
    conv_cache = conv_in[:, -(s.d_conv - 1):, :]
    xh, Bc, Cc, dtv = _ssd_inputs(cfg, p, conv_in, dt)
    y, state = _ssd_local(functools.partial(ssd_chunked, chunk=s.chunk,
                                            rules=rules), xh, dtv, a, Bc, Cc)
    y = y + p["d_skip"].to(dt_)[None, None, :, None] * xh
    out = _mix_out(cfg, p, y, z, dt_)
    out = shard_constraint(out, rules, "batch", "seq", None)
    return out, {"conv": conv_cache, "state": state}


def ssm_mixer(cfg: ModelConfig, rules: ShardingRules, p: dict, x, *,
              cache=None):
    """Mamba2 block mixer. x: [B,S,D]. cache (decode): {'conv': [B,K-1,Cd],
    'state': [B,H,P,N]} -> returns (y, cache). Decode updates the cache
    tensors IN PLACE and returns them."""
    s = cfg.ssm
    dt_ = x.dtype
    d_inner, heads, _ = _dims(cfg)
    z, conv_in, dt, a = _conv_inputs(cfg, p, x)

    if cache is None:
        xh, Bc, Cc, dtv = _ssd_inputs(cfg, p, conv_in, dt)
        if cfg.use_pallas:
            y, _ = _ssd_kernel(xh, dtv, a, Bc, Cc, chunk=s.chunk)
        else:
            y, _ = _ssd_local(functools.partial(
                ssd_chunked, chunk=s.chunk, rules=rules), xh, dtv, a, Bc, Cc)
        y = y + p["d_skip"].to(dt_)[None, None, :, None] * xh
        new_cache = None
    else:
        # single-token recurrent update (S == 1)
        window = torch.cat([cache["conv"], conv_in], dim=1)  # [B,K,Cd]
        w = p["conv_w"].to(dt_)
        conv_out = F.silu(
            torch.einsum("bkc,kc->bc", window, w) + p["conv_b"].to(dt_)
        )[:, None, :]
        xs, Bc, Cc = torch.split(conv_out, [d_inner, s.d_state, s.d_state],
                                 dim=-1)
        xh = xs.reshape(xs.shape[0], heads, s.head_dim)  # [B,H,P]
        dtv = F.softplus(dt[:, 0].float() + p["dt_bias"].float())  # [B,H]
        dA = torch.exp(dtv * a)  # [B,H]
        state = cache["state"].float()
        upd = torch.einsum("bh,bhp,bn->bhpn", dtv, xh.float(),
                           Bc[:, 0].float())
        state = state * dA[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cc[:, 0].float(), state)
        y = y.to(dt_) + p["d_skip"].to(dt_)[None, :, None] * xh
        y = y[:, None]  # [B,1,H,P]
        cache["conv"].copy_(window[:, 1:])
        cache["state"].copy_(state)
        new_cache = cache

    out = _mix_out(cfg, p, y, z, dt_)
    return shard_constraint(out, rules, "batch", "seq", None), new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, n_layers: int, dtype,
                   device=None):
    s = cfg.ssm
    d_inner, heads, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((n_layers, batch, s.d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((n_layers, batch, heads, s.head_dim, s.d_state),
                             dtype=dtype, device=device),
    }


def ssm_cache_logical() -> dict:
    return {
        "conv": ("layers", "batch", None, "tp"),
        "state": ("layers", "batch", "tp", None, None),
    }
