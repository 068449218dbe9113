"""Plain PyTorch version of the flash attention kernel (GQA, causal,
window): the reference's ``attention_bhsd_ref``, op for op."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_bhsd_ref(q, k, v, *, q_per_kv: int, causal: bool = True,
                       window: int | None = None, scale: float = 1.0):
    """q: [B,H,S,D], k/v: [B,Kv,S,D] -> [B,H,S,D], f32 softmax; the
    weights are cast to v's type before the product with v."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    qg = q.reshape(b, kvh, q_per_kv, s, d)
    scores = torch.einsum(
        "bkgqd,bksd->bkgqs", qg.float(), k.float()
    ) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w.to(v.dtype), v)
    return out.reshape(b, h, s, d)
