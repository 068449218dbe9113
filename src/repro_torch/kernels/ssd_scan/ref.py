"""Plain PyTorch version of the SSD scan kernel: the reference's
``ssd_scan_bhsp_ref`` op for op, in the kernel's [B,H,S,P] layout, all
math in f32."""

from __future__ import annotations

import torch


def ssd_scan_bhsp_ref(x, dt, a, bm, cm, *, chunk: int):
    """x [B,H,S,P], dt [B,H,S], a [H], bm/cm [B,S,N] ->
    (y [B,H,S,P] in x's type, final state [B,H,P,N] f32)."""
    b, h, s, p = x.shape
    n = bm.shape[-1]
    nc = s // chunk
    f32 = torch.float32
    xr = x.reshape(b, h, nc, chunk, p).to(f32)
    dtr = dt.reshape(b, h, nc, chunk).to(f32)
    br = bm.reshape(b, nc, chunk, n).to(f32)
    cr = cm.reshape(b, nc, chunk, n).to(f32)

    da = dtr * a.to(f32)[None, :, None, None]
    cum = torch.cumsum(da, dim=-1)  # [b,h,nc,Q]
    diff = cum[..., :, None] - cum[..., None, :]
    ii = torch.arange(chunk, device=x.device)
    mask = (ii[:, None] >= ii[None, :])[None, None, None]
    cb = torch.einsum("bcin,bcjn->bcij", cr, br)
    # exp only where i >= j: above the diagonal diff > 0 may overflow
    decay = torch.exp(torch.where(mask, diff, 0.0))
    scores = torch.where(mask, cb[:, None] * decay * dtr[..., None, :], 0.0)
    y_intra = torch.einsum("bhcij,bhcjp->bhcip", scores, xr)

    cum_last = cum[..., -1:]
    w_end = torch.exp(cum_last - cum) * dtr
    s_chunk = torch.einsum("bhcj,bhcjp,bcjn->bhcpn", w_end, xr, br)
    dec = torch.exp(cum_last[..., 0])  # [b,h,nc]

    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(state)
        state = state * dec[:, :, c, None, None] + s_chunk[:, :, c]
    s_prev = torch.stack(s_prevs, dim=2)  # [b,h,nc,p,n]
    y_inter = torch.einsum("bcin,bhcpn->bhcip", cr, s_prev) * torch.exp(
        cum
    )[..., None]
    y = (y_intra + y_inter).reshape(b, h, s, p).to(x.dtype)
    return y, state
