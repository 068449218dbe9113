"""Batched LP solving across RHS variants — engine dispatch + numpy engine.

The planner's hot path (Pareto sweeps, feasibility-repair probes, round-down
refits) produces *batches* of LPs that share (c, A_ub, A_eq) and differ only
in b. Two engines solve such a batch:

  * ``engine="torch"`` — the batched fixed-iteration IPM in ``ipm_torch.py``
    on a torch device (the card by default): all samples in flight, one
    batched LU per iteration.
  * ``engine="numpy"`` — this module's batched Mehrotra predictor-corrector.
    All per-iteration linear algebra runs through numpy's *stacked* LAPACK
    gufuncs (``np.linalg.solve`` on [B, m, m]). Samples converge adaptively
    and are compacted out of the batch, so a sweep pays ~25-45 iterations
    per sample instead of a fixed worst-case count.

The caller names the engine; nothing here looks at which hardware is
present. ``solve_lp_batched_with_fallback`` adds the per-sample KKT
fallback: any sample the batched engine fails to certify is re-solved by
the sequential reference IPM, so callers always get numpy-reference-grade
answers. The ``planner.ipm_resolves`` counter records those re-solves and
``planner.ipm_batched_samples`` the samples that entered a batched solve.
"""

from __future__ import annotations

import numpy as np

from repro_torch.obs.metrics import REGISTRY

from .ipm import _normal_matrix, _ruiz_equilibrate, solve_lp

_EPS = 1e-11
ENGINES = ("numpy", "torch")
_resolves = REGISTRY.counter("planner.ipm_resolves")
_batched_samples = REGISTRY.counter("planner.ipm_batched_samples")


def _max_step_batched(v: np.ndarray, dv: np.ndarray) -> np.ndarray:
    """Per-sample max alpha with v + alpha*dv >= 0. [B, n] -> [B]."""
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(dv < 0, -v / dv, np.inf)
    return np.minimum(1.0, ratio.min(axis=1))


def _solve_normal_batched(M: np.ndarray, rhs: np.ndarray, reg0: float) -> np.ndarray:
    """Solve (M_b + reg*tr_b*I) y_b = rhs_b for a stack of normal matrices.

    Batched LU via np.linalg.solve; regularization escalates for the whole
    batch on (rare) exact singularity, mirroring the sequential solver.
    """
    m = M.shape[-1]
    tr = np.maximum(np.trace(M, axis1=1, axis2=2) / max(m, 1), 1.0)
    eye = np.eye(m)
    reg = reg0
    for _ in range(6):
        try:
            return np.linalg.solve(
                M + (reg * tr)[:, None, None] * eye, rhs[..., None]
            )[..., 0]
        except np.linalg.LinAlgError:
            reg *= 100.0
    out = np.empty_like(rhs)
    for i in range(M.shape[0]):
        out[i] = np.linalg.lstsq(
            M[i] + reg * tr[i] * eye, rhs[i], rcond=None
        )[0]
    return out


def solve_standard_form_batched(
    A: np.ndarray,
    bs: np.ndarray,
    c: np.ndarray,
    *,
    tol: float = 1e-9,
    max_iter: int = 100,
    n_slack: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched Mehrotra on  min c@x s.t. A@x=b_i, x>=0  for shared (A, c).

    Returns (x [B, n], fun [B], ok [B]). Per-sample iterates follow the
    sequential ``solve_standard_form`` (shared equilibration, same starting
    point, same stopping rules); converged/stalled samples drop out of the
    batch so the remaining ones keep full LAPACK batch width.
    """
    A = np.asarray(A, dtype=np.float64)
    bs = np.asarray(bs, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    B = bs.shape[0]
    m, n = A.shape
    if m == 0:
        return np.zeros((B, n)), np.zeros(B), np.ones(B, dtype=bool)

    As, rsc, csc = _ruiz_equilibrate(A)
    bs_s = bs / rsc[None, :]
    cs = c / csc
    nc = n - n_slack
    slack_diag = (
        As[np.arange(n_slack), nc + np.arange(n_slack)] if n_slack else None
    )
    core = As[:, :nc]

    def normal_matrices(D: np.ndarray) -> np.ndarray:
        # M_b = A diag(D_b) A^T, slack identity block folded into the diagonal.
        # Broadcasted matmul (batched BLAS dgemm) — einsum would bypass BLAS.
        M = (core[None, :, :] * D[:, None, :nc]) @ core.T
        if n_slack:
            sl = np.arange(n_slack)
            M[:, sl, sl] += slack_diag * slack_diag * D[:, nc:]
        return M

    bnorm = 1.0 + np.linalg.norm(bs_s, axis=1)
    cnorm = 1.0 + np.linalg.norm(cs)

    # ---- Mehrotra starting point (shared factor, per-sample b)
    AAt = _normal_matrix(As, np.ones(n), n_slack, slack_diag)
    tr = max(np.trace(AAt) / m, 1.0)
    AAt_reg = AAt + 1e-10 * tr * np.eye(m)
    try:
        X = (As.T @ np.linalg.solve(AAt_reg, bs_s.T)).T
        y0 = np.linalg.solve(AAt_reg, As @ cs)
    except np.linalg.LinAlgError:
        X = (As.T @ np.linalg.lstsq(AAt_reg, bs_s.T, rcond=None)[0]).T
        y0 = np.linalg.lstsq(AAt_reg, As @ cs, rcond=None)[0]
    s0 = cs - As.T @ y0
    S = np.tile(s0[None, :], (B, 1))
    Y = np.tile(y0[None, :], (B, 1))
    dx = np.maximum(-1.5 * X.min(axis=1, initial=0.0), 0.0)
    ds = np.maximum(-1.5 * S.min(axis=1, initial=0.0), 0.0)
    X = X + dx[:, None]
    S = S + ds[:, None]
    xs = np.einsum("bi,bi->b", X, S)
    bad = xs <= 0
    X[bad] = 1.0
    S[bad] = 1.0
    xs[bad] = float(n)
    X = X + 0.5 * (xs / np.maximum(S.sum(axis=1), _EPS))[:, None]
    S = S + 0.5 * (xs / np.maximum(X.sum(axis=1), _EPS))[:, None]
    X = np.maximum(X, 1e-4)
    S = np.maximum(S, 1e-4)

    # active-sample bookkeeping (batch compaction)
    idx = np.arange(B)
    best_pres = np.full(B, np.inf)
    stall = np.zeros(B, dtype=np.int64)
    best_gap = np.full(B, np.inf)
    floor_stall = np.zeros(B, dtype=np.int64)
    out_x = np.zeros((B, n))
    out_ok = np.zeros(B, dtype=bool)

    def finalize(sel_local, optimal: np.ndarray):
        """Record finished samples (local indices into the active batch)."""
        gi = idx[sel_local]
        out_x[gi] = X[sel_local]
        out_ok[gi] = optimal

    for it in range(1, max_iter + 1):
        rb = X @ As.T - bs_s
        rc = Y @ As + S - cs
        mu = np.einsum("bi,bi->b", X, S) / n
        pres = np.linalg.norm(rb, axis=1) / bnorm[idx]
        dres = np.linalg.norm(rc, axis=1) / cnorm
        gap = n * mu / (1.0 + np.abs(np.einsum("i,bi->b", cs, X)))

        converged = (pres < tol) & (dres < tol) & (gap < tol)
        # floor acceptance (mirrors the sequential solver): residuals below
        # the relaxed 1e-7 threshold with a gap that stopped halving
        gap_improving = gap < best_gap * 0.5
        best_gap = np.where(gap_improving, gap, best_gap)
        floor_stall = np.where(gap_improving, 0, floor_stall + 1)
        converged |= (
            (pres < 1e-7) & (dres < 1e-7) & (gap < 1e-7) & (floor_stall >= 5)
        )
        improving = pres < best_pres * 0.9
        best_pres = np.where(improving, pres, best_pres)
        stall = np.where(improving, 0, stall + 1)
        stalled = (stall >= 12) & (pres > 1e-6) & ~converged
        # out of iterations: apply the sequential solver's relaxed acceptance
        if it == max_iter:
            converged = converged | ((pres < 1e-7) & (dres < 1e-7) & (gap < 1e-7))
            stalled = ~converged
        finished = converged | stalled
        if finished.any():
            finalize(np.flatnonzero(finished), converged[finished])
            keep = ~finished
            if not keep.any():
                break
            X, Y, S = X[keep], Y[keep], S[keep]
            rb, rc, mu = rb[keep], rc[keep], mu[keep]
            bs_s = bs_s[keep]
            idx = idx[keep]
            best_pres, stall = best_pres[keep], stall[keep]
            best_gap, floor_stall = best_gap[keep], floor_stall[keep]

        D = X / S
        M = normal_matrices(D)

        # predictor (affine) step
        r_xs = X * S
        rhs = -rb - (D * rc - r_xs / S) @ As.T
        dY_a = _solve_normal_batched(M, rhs, 1e-12)
        dX_a = D * (dY_a @ As + rc) - r_xs / S
        dS_a = -(r_xs + S * dX_a) / X

        a_pri = _max_step_batched(X, dX_a)
        a_dua = _max_step_batched(S, dS_a)
        mu_aff = (
            np.einsum("bi,bi->b", X + a_pri[:, None] * dX_a,
                      S + a_dua[:, None] * dS_a) / n
        )
        sigma = np.clip((mu_aff / np.maximum(mu, _EPS)) ** 3, 0.0, 1.0)

        # corrector step (same normal matrices, second batched factorization)
        r_xs = X * S + dX_a * dS_a - (sigma * mu)[:, None]
        rhs = -rb - (D * rc - r_xs / S) @ As.T
        dY = _solve_normal_batched(M, rhs, 1e-12)
        dX = D * (dY @ As + rc) - r_xs / S
        dS = -(r_xs + S * dX) / X

        eta = min(0.999, 0.9 + 0.09 * it / max_iter)
        a_pri = eta * _max_step_batched(X, dX)
        a_dua = eta * _max_step_batched(S, dS)
        X = np.maximum(X + a_pri[:, None] * dX, _EPS)
        Y = Y + a_dua[:, None] * dY
        S = np.maximum(S + a_dua[:, None] * dS, _EPS)

    x_orig = out_x / csc[None, :]
    return x_orig, x_orig @ c, out_ok


def solve_lp_batched(
    c, A_ub, b_ub_batch, A_eq, b_eq, *, tol: float = 1e-9, max_iter: int = 100
):
    """numpy-engine batch solve of min c@x, A_ub@x <= b_i, A_eq@x = b_eq_i.

    Same contract as ``ipm_torch.solve_lp_batched``: b_eq may be [m_eq] or
    [B, m_eq]; returns (x [B, n], fun [B], ok [B])."""
    c = np.asarray(c, dtype=np.float64)
    A_ub = np.asarray(A_ub, dtype=np.float64)
    b_ub_batch = np.asarray(b_ub_batch, dtype=np.float64)
    n = c.shape[0]
    m_ub = A_ub.shape[0] if A_ub.size else 0
    m_eq = A_eq.shape[0] if A_eq is not None and A_eq.size else 0
    B = b_ub_batch.shape[0]
    A = np.zeros((m_ub + m_eq, n + m_ub))
    if m_ub:
        A[:m_ub, :n] = A_ub
        A[:m_ub, n:] = np.eye(m_ub)
    if m_eq:
        A[m_ub:, :n] = A_eq
    bs = np.zeros((B, m_ub + m_eq))
    bs[:, :m_ub] = b_ub_batch
    if m_eq:
        bs[:, m_ub:] = np.asarray(b_eq, np.float64)
    c_std = np.concatenate([c, np.zeros(m_ub)])
    x, _, ok = solve_standard_form_batched(
        A, bs, c_std, tol=tol, max_iter=max_iter, n_slack=m_ub
    )
    x = x[:, :n]
    return x, x @ c, ok


def _pick_engine(engine: str) -> str:
    if engine not in ENGINES:
        raise ValueError(f"unknown batch engine {engine!r} (one of {ENGINES})")
    return engine


def solve_lp_batched_auto(c, A_ub, b_ub_batch, A_eq, b_eq, *,
                          engine: str = "numpy", device=None,
                          iters: int = 40):
    """Engine-dispatched batch solve without the sequential fallback pass.

    Same (x, fun, ok) contract as both engines; ``ok`` is the engine's own
    KKT certificate. ``device`` is the torch engine's device (None = the
    card)."""
    _batched_samples.inc(len(b_ub_batch))
    if _pick_engine(engine) == "torch":
        from .ipm_torch import solve_lp_batched as torch_batched

        return torch_batched(c, A_ub, b_ub_batch, A_eq, b_eq, iters=iters,
                             device=device)
    return solve_lp_batched(c, A_ub, b_ub_batch, A_eq, b_eq)


def solve_lp_batched_with_fallback(
    c, A_ub, b_ub_batch, A_eq, b_eq, *, engine: str = "numpy", device=None,
    iters: int = 40,
):
    """Batch solve + per-sample sequential re-solve of uncertified samples.

    Returns (x, fun, ok, n_fallback); ``ok`` afterwards means "solved to the
    sequential numpy reference's standard" — samples still not-ok are
    genuinely infeasible/unbounded there too.
    """
    x, fun, ok = solve_lp_batched_auto(
        c, A_ub, b_ub_batch, A_eq, b_eq, engine=engine, device=device,
        iters=iters,
    )
    bad = np.flatnonzero(~ok)
    if bad.size:
        x, fun, ok = np.array(x), np.array(fun), np.array(ok)
    _resolves.inc(len(bad))
    b_eq_arr = np.asarray(b_eq, np.float64) if b_eq is not None else np.zeros(0)
    for i in bad:
        b_eq_i = b_eq_arr[i] if b_eq_arr.ndim == 2 else b_eq_arr
        res = solve_lp(c, A_ub, b_ub_batch[i], A_eq, b_eq_i)
        x[i] = res.x
        fun[i] = res.fun
        ok[i] = res.ok
    return x, fun, ok, len(bad)
