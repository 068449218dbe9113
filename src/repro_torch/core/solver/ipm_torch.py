"""Batched torch interior-point LP solver for the planner's solve pipelines.

The port of the reference package's ``core/solver/ipm_jax.py``. The
planner's §5.2 sweep and §5.1.3 round-down stages produce batches of LPs
that share (c, A_ub, A_eq) and differ only in b. Here one fixed-iteration
Mehrotra predictor-corrector runs in float64 on a torch device, with the
batch as a leading tensor dimension and the 40 iterations as a Python
loop. Each iteration LU-factorizes the batch of normal matrices once
(``torch.linalg.lu_factor``) and reuses the factors for the predictor and
corrector solves. Batch sizes are padded up to power-of-two buckets, as
in the reference, so every sweep solves the same problem shapes.

``solve_lp_batched`` keeps the reference's ``(x, fun, ok)`` contract: ``ok``
is a per-sample KKT check (primal/dual residuals and gap below 1e-7);
``ipm_batch.solve_lp_batched_with_fallback`` re-solves the samples it
does not certify with the numpy IPM.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

_EPS = 1e-11
_KKT_TOL = 1e-7


def _build_standard(c, A_ub, A_eq):
    """Standard-form matrix [A_ub I; A_eq 0] and extended objective."""
    n = c.shape[0]
    m_ub = A_ub.shape[0] if A_ub is not None and A_ub.size else 0
    m_eq = A_eq.shape[0] if A_eq is not None and A_eq.size else 0
    A = np.zeros((m_ub + m_eq, n + m_ub))
    if m_ub:
        A[:m_ub, :n] = A_ub
        A[:m_ub, n:] = np.eye(m_ub)
    if m_eq:
        A[m_ub:, :n] = A_eq
    cs = np.concatenate([c, np.zeros(m_ub)])
    return A, cs, m_ub, m_eq


def _maxstep(v: torch.Tensor, dv: torch.Tensor) -> torch.Tensor:
    """Per-sample largest alpha <= 1 with v + alpha*dv >= 0. [B, n] -> [B]."""
    neg = dv < 0
    r = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
    return torch.clamp(r.amin(dim=1), max=1.0)


def _solve_batched(A, bs, c, iters: int = 40, n_slack: int = 0):
    """min c@x s.t. A@x=b_i, x>=0 for a batch of b vectors [B, m], f64."""
    m, n = A.shape
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    nc = n - n_slack
    core = A[:, :nc]
    sl = torch.arange(n_slack, device=A.device)
    slack_diag = A[sl, nc + sl] if n_slack else None

    def normal_matrix(d):
        # A D A^T; the slack identity block only adds to the diagonal
        M = (core * d[..., None, :nc]) @ core.T
        if n_slack:
            M[..., sl, sl] += slack_diag * slack_diag * d[..., nc:]
        return M

    def reg_lu(M):
        tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / m
        return torch.linalg.lu_factor(M + 1e-11 * tr[..., None, None] * eye)

    def lu_solve(lu, rhs):
        return torch.linalg.lu_solve(lu[0], lu[1], rhs[..., None])[..., 0]

    # the starting-point factor depends only on A: shared by the batch
    lu0 = reg_lu(normal_matrix(torch.ones(n, dtype=A.dtype, device=A.device)))
    y0 = lu_solve(lu0, A @ c)
    s0 = c - A.T @ y0
    B = bs.shape[0]
    x = torch.linalg.lu_solve(lu0[0], lu0[1], bs.T).T @ A
    y = y0.expand(B, m).clone()
    s = s0.expand(B, n).clone()
    dx = torch.clamp(-1.5 * x.amin(dim=1), min=0.0)
    ds = torch.clamp(-1.5 * s.amin(dim=1), min=0.0)
    x = x + dx[:, None]
    s = s + ds[:, None]
    xs = torch.clamp((x * s).sum(1), min=1e-2)
    x = torch.clamp(
        x + (0.5 * xs / torch.clamp(s.sum(1), min=_EPS))[:, None], min=1e-4
    )
    s = torch.clamp(
        s + (0.5 * xs / torch.clamp(x.sum(1), min=_EPS))[:, None], min=1e-4
    )

    for _ in range(iters):
        rb = x @ A.T - bs
        rc = y @ A + s - c
        mu = (x * s).sum(1) / n
        d = x / s
        # one factorization serves the predictor and corrector solves
        lu = reg_lu(normal_matrix(d))

        r_xs = x * s
        rhs = -rb - (d * rc - r_xs / s) @ A.T
        dy_a = lu_solve(lu, rhs)
        dx_a = d * (dy_a @ A + rc) - r_xs / s
        ds_a = -(r_xs + s * dx_a) / x

        ap = _maxstep(x, dx_a)
        ad = _maxstep(s, ds_a)
        mu_a = ((x + ap[:, None] * dx_a) * (s + ad[:, None] * ds_a)).sum(1) / n
        sigma = torch.clamp((mu_a / torch.clamp(mu, min=_EPS)) ** 3, 0.0, 1.0)

        r_xs2 = x * s + dx_a * ds_a - (sigma * mu)[:, None]
        rhs2 = -rb - (d * rc - r_xs2 / s) @ A.T
        dy = lu_solve(lu, rhs2)
        dxv = d * (dy @ A + rc) - r_xs2 / s
        dsv = -(r_xs2 + s * dxv) / x

        ap = 0.99 * _maxstep(x, dxv)
        ad = 0.99 * _maxstep(s, dsv)
        x = torch.clamp(x + ap[:, None] * dxv, min=_EPS)
        y = y + ad[:, None] * dy
        s = torch.clamp(s + ad[:, None] * dsv, min=_EPS)

    pres = torch.linalg.norm(x @ A.T - bs, dim=1) / (
        1.0 + torch.linalg.norm(bs, dim=1)
    )
    dres = torch.linalg.norm(y @ A + s - c, dim=1) / (
        1.0 + torch.linalg.norm(c)
    )
    fun = x @ c
    gap = (x * s).sum(1) / (1.0 + torch.abs(fun))
    return x, fun, pres, gap, dres


def _bucket(n: int) -> int:
    """Next power of two >= n: a sweep solves a handful of batch shapes."""
    b = 1
    while b < n:
        b *= 2
    return b


def solve_lp_batched(c, A_ub, b_ub_batch, A_eq, b_eq, *, iters: int = 40,
                     device=None):
    """Solve a batch of LPs sharing (c, A_ub, A_eq) but differing in RHS.

    b_ub_batch: [B, m_ub]; b_eq may be [m_eq] (shared) or [B, m_eq] (e.g.
    per-sample pinned-variable shifts). Inputs and outputs are numpy
    arrays; the solve runs in float64 on ``device`` (None = the card).
    Returns (x [B, n], fun [B], ok [B]) where ok is a per-sample KKT check
    (primal/dual residuals + gap).
    """
    dev = resolve_device(device)
    c = np.asarray(c, np.float64)
    A, cs, m_ub, m_eq = _build_standard(
        c,
        np.asarray(A_ub, np.float64),
        np.asarray(A_eq, np.float64) if A_eq is not None else None,
    )
    b_ub_batch = np.asarray(b_ub_batch, np.float64)
    B = b_ub_batch.shape[0]
    bs = np.zeros((B, m_ub + m_eq))
    bs[:, :m_ub] = b_ub_batch
    if m_eq:
        bs[:, m_ub:] = np.asarray(b_eq, np.float64)  # [m_eq] or [B, m_eq]
    pad = _bucket(B) - B
    if pad:
        bs = np.concatenate([bs, np.tile(bs[:1], (pad, 1))], axis=0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    x, fun, pres, gap, dres = _solve_batched(
        t(A), t(bs), t(cs), iters=iters, n_slack=m_ub
    )
    x = x[:B, : c.shape[0]].cpu().numpy()
    pres, gap, dres = (a[:B].cpu().numpy() for a in (pres, gap, dres))
    ok = (
        (pres < _KKT_TOL) & (gap < _KKT_TOL) & (dres < _KKT_TOL)
        & np.isfinite(pres) & np.isfinite(gap) & np.isfinite(dres)
    )
    return x, fun[:B].cpu().numpy(), ok
