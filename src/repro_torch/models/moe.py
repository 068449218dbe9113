"""Mixture-of-Experts FFN with top-k routing and capacity-bounded dispatch
(the port of ``repro/models/moe.py``).

Dispatch is sort-based, as in the reference: the flattened token-major
[T*k] assignments are sorted by expert id (a stable argsort), each takes
its position within its expert, the tokens are scattered into an
[E, C, D] buffer, the experts run their three products, and the outputs
are combined back in token order. An assignment at position >= C is
dropped: its source row adds zeros into slot C-1. The reference computes
all of this in jnp outside any Pallas kernel, so the products here are
library products too.

Two choices pin the port to the reference's numbers where torch leaves
the order open:
  * top-k is a stable descending sort, so ties go to the lower expert id
    as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no order);
  * the combine adds each token's k contributions one at a time in
    ascending expert order, rounding after each add, as the reference's
    scatter-add does; ``index_add_`` on CUDA adds in any order.

Inside ``record_routing()`` every call appends what it decided (experts,
the top k+1 probabilities, which assignments were kept) to a list, so that
a caller can compare routing before it compares outputs.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.specs import (
    ShardingRules,
    current_mesh,
    is_dtensor,
    local_call,
    mesh_axis_sizes,
    shard_constraint,
    shards_of,
    unshard,
)
from .params import ParamDef

_RECORD: contextvars.ContextVar = contextvars.ContextVar("moe_routing",
                                                         default=None)


def moe_defs(cfg: ModelConfig, lead: tuple[int, ...] = ()) -> dict:
    assert cfg.moe is not None
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    ll = tuple(["layers"] * len(lead))
    if cfg.moe_shard_dispatch:
        wi_l = ll + ("expert", "fsdp", "tp")
        wo_l = ll + ("expert", "tp", "fsdp")
    else:
        wi_l = ll + ("expert", "fsdp", None)
        wo_l = ll + ("expert", None, "fsdp")
    defs = {
        "router": ParamDef(lead + (d, e), ll + ("fsdp", None), fan_in=d),
        "wi": ParamDef(lead + (e, d, f), wi_l, fan_in=d),
        "wo": ParamDef(lead + (e, f, d), wo_l, fan_in=f),
    }
    if cfg.activation != "relu2":
        defs["wg"] = ParamDef(lead + (e, d, f), wi_l, fan_in=d)
    return defs


def capacity(cfg: ModelConfig, tokens: int) -> int:
    m = cfg.moe
    c = int(tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling friendliness


def _batch_shards(rules: ShardingRules) -> int:
    """Number of shards along the logical batch axis on the current mesh
    (``set_mesh``); 1 without one."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    ax = rules.filter_for_mesh(mesh).batch
    if ax is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n *= sizes.get(a, 1)
    return max(n, 1)


@contextlib.contextmanager
def record_routing():
    """Collect every MoE call's routing while the block runs: a list of
    dicts with ``experts`` [T, k] (long), ``probs`` [T, k+1] (the largest
    k+1 router probabilities, f32, descending) and ``keep`` [T, k] (bool,
    False where capacity dropped the assignment), in token-major order."""
    recs: list = []
    token = _RECORD.set(recs)
    try:
        yield recs
    finally:
        _RECORD.reset(token)


def _experts(cfg: ModelConfig, p: dict, buf, dt):
    """The expert FFN on the dispatch buffer [G, E, C, D]."""
    h = torch.einsum("gecd,edf->gecf", buf, p["wi"].to(dt))
    if cfg.activation == "relu2":
        return torch.einsum("gecf,efd->gecd", torch.square(F.relu(h)),
                            p["wo"].to(dt))
    g = torch.einsum("gecd,edf->gecf", buf, p["wg"].to(dt))
    if cfg.activation == "silu":
        h = F.silu(g) * h
    else:
        h = F.gelu(g, approximate="tanh") * h
    return torch.einsum("gecf,efd->gecd", h, p["wo"].to(dt))


def _moe(cfg: ModelConfig, p: dict, xt, psum_combine: bool):
    """Route, dispatch, run and combine the tokens of xt [G, T, D], each of
    the G groups on its own with capacity ``capacity(cfg, T)``."""
    m = cfg.moe
    dt = xt.dtype
    n_g, t, d = xt.shape
    k, e = m.top_k, m.num_experts
    cap = capacity(cfg, t)
    dev = xt.device

    # f32 products of activation-type values (preferred_element_type=f32)
    logits = xt.float() @ p["router"].to(dt).float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = top[..., :k], idx[..., :k]  # [G, T, k]
    gates = (gates / torch.sum(gates, dim=-1, keepdim=True)).to(dt)

    fe = eidx.reshape(n_g, t * k)
    ftok = torch.arange(t, device=dev).repeat_interleave(k).expand(n_g, -1)
    order = torch.argsort(fe, dim=-1, stable=True)
    se = torch.gather(fe, 1, order)
    stok = torch.gather(ftok, 1, order)
    starts = torch.searchsorted(
        se, torch.arange(e, device=dev).expand(n_g, -1).contiguous())
    pos = (torch.arange(t * k, device=dev)[None]
           - torch.gather(starts, 1, se))
    keep = pos < cap
    posc = torch.clamp(pos, max=cap - 1)
    gi = torch.arange(n_g, device=dev)[:, None].expand(-1, t * k)

    # dispatch: [G, E, C, D]; a dropped assignment adds zeros into C-1
    src = xt[gi, stok] * keep[..., None].to(dt)
    buf = xt.new_zeros((n_g, e, cap, d)).index_put(
        (gi, se, posc), src, accumulate=True)
    outb = _experts(cfg, p, buf, dt)

    # each assignment's slot, back in token-major order
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(t * k, device=dev).expand(n_g, -1))
    keep_o = torch.gather(keep, 1, inv)
    posc_o = torch.gather(posc, 1, inv)
    fg = gates.reshape(n_g, t * k)
    if psum_combine:
        # the reference sets slot owners with a scatter whose duplicate
        # writes land in sorted order, so the last assignment of an
        # overflowing expert (a dropped one) owns slot C-1: the token kept
        # there is lost too. An assignment contributes only through a slot
        # it owns.
        count = torch.diff(starts, dim=1, append=torch.full(
            (n_g, 1), t * k, device=dev, dtype=starts.dtype))
        last = pos == torch.gather(count, 1, se) - 1
        owner = (pos < cap - 1) | last
        owner_o = torch.gather(owner, 1, inv)
        weight = fg * (keep_o & owner_o).to(dt)
    else:
        weight = fg * keep_o.to(dt)
    vals = outb[gi, fe, posc_o] * weight[..., None]  # [G, T*k, D]

    # combine: each token's k contributions added in ascending expert order
    by_expert = torch.argsort(eidx, dim=-1)  # experts of a token differ
    vals = torch.gather(vals.reshape(n_g, t, k, d), 2,
                        by_expert[..., None].expand(-1, -1, -1, d))
    y = xt.new_zeros((n_g, t, d))
    for j in range(k):
        y = y + vals[:, :, j]

    recs = _RECORD.get()
    if recs is not None:
        recs.append({
            "experts": eidx.reshape(n_g * t, k).detach(),
            "probs": top[..., :k + 1].reshape(n_g * t, -1).detach(),
            "keep": keep_o.reshape(n_g * t, k).detach(),
        })
    return y


def _moe_tokens(cfg: ModelConfig, p: dict, x, n_g: int,
                psum_combine: bool):
    """``_moe`` on x [B, S, D] cut into ``n_g`` groups of consecutive
    tokens, back as [B, S, D]. Every group routes, sorts and places its
    tokens on its own, so a DTensor runs on each rank's local rows where
    the mesh axes that shard its batch dim hold one group each, and whole
    on every rank otherwise. Its experts are gathered whole: DTensor has
    no strategy for the sort, the searchsorted and the indexed scatter,
    and GSPMD keeps the dispatch shard-local too. A weight's gradient is
    then a partial sum over the mesh axes that shard the groups."""
    b, s, d = x.shape
    if not is_dtensor(x):
        return _moe(cfg, p, x.reshape(n_g, b * s // n_g, d),
                    psum_combine).reshape(b, s, d)
    from torch.distributed.tensor import Partial, Replicate, Shard

    x = unshard(x, 1, 2)
    shards = shards_of(x, 0)
    if shards != n_g or b % n_g:
        x, shards = unshard(x), 1
    whole = [Replicate()] * x.device_mesh.ndim
    grad = [Partial() if isinstance(pl, Shard) else Replicate()
            for pl in x.placements]

    def run(xl, *ws):
        return _moe(cfg, dict(zip(p, ws)), xl.reshape(n_g // shards, -1, d),
                    psum_combine).reshape(xl.shape)

    return local_call(run, (x, *p.values()),
                      (x.placements,) + (whole,) * len(p), x.placements,
                      x.shape, (x.placements,) + (grad,) * len(p))


def moe_mlp_sharded(cfg: ModelConfig, rules: ShardingRules, p: dict, x):
    """Shard-local dispatch: every data shard routes, sorts and places its
    own tokens, with capacity per shard; the shards are the product of the
    mesh axes that ``rules.batch`` names (``_batch_shards``), one without
    a mesh, and then this computes what ``moe_mlp`` does, but for the
    combine that ``cfg.moe_psum_combine`` selects (scatter from the expert
    slots, whose owners the reference sets last-write-wins)."""
    b, s, d = x.shape
    t = b * s
    n_sh = _batch_shards(rules)
    if t % n_sh or (t // n_sh) < 1:
        n_sh = 1
    y = _moe_tokens(cfg, p, x, n_sh, cfg.moe_psum_combine)
    return shard_constraint(y, rules, "batch", None, None)


def moe_mlp(cfg: ModelConfig, rules: ShardingRules, p: dict, x):
    """x: [B, S, D] -> [B, S, D]."""
    if cfg.moe_shard_dispatch:
        return moe_mlp_sharded(cfg, rules, p, x)
    y = _moe_tokens(cfg, p, x, 1, False)
    return shard_constraint(y, rules, "batch", None, None)
