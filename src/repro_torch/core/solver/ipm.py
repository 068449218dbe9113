"""Dense primal-dual interior-point LP solver (Mehrotra predictor-corrector).

The paper solves its MILP with Gurobi (or Coin-OR). Neither is available
offline, so the framework ships its own solver. Problems produced by
``core.milp`` are small and dense (a pruned candidate graph has ~12
regions -> ~300 variables), so a dense normal-equations IPM is both simple
and fast (<10 ms per solve), and — unlike simplex — trivially portable to a
batched torch implementation (see ``ipm_torch.py``) for Pareto-frontier sweeps.

Standard form solved here:   min c@x   s.t.  A@x = b,  x >= 0
``solve_lp`` converts an inequality/equality description by appending slacks.

Reference: S. Wright, *Primal-Dual Interior-Point Methods*, SIAM 1997, ch. 10.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_EPS = 1e-11


@dataclasses.dataclass
class IPMResult:
    x: np.ndarray  # primal solution (original variables, slacks stripped)
    fun: float
    status: str  # "optimal" | "max_iter" | "infeasible"
    iterations: int
    gap: float
    primal_residual: float
    dual_residual: float

    @property
    def ok(self) -> bool:
        return self.status == "optimal"


def _ruiz_equilibrate(A: np.ndarray, iters: int = 6):
    """Ruiz row/col equilibration; returns (A_scaled, row_scale, col_scale)."""
    m, n = A.shape
    r = np.ones(m)
    c = np.ones(n)
    As = A.copy()
    for _ in range(iters):
        row_norm = np.sqrt(np.maximum(np.abs(As).max(axis=1), _EPS))
        col_norm = np.sqrt(np.maximum(np.abs(As).max(axis=0), _EPS))
        As = As / row_norm[:, None] / col_norm[None, :]
        r *= row_norm
        c *= col_norm
    return As, r, c


class _NormalFactor:
    """Cholesky of (A D A^T + reg I) with escalating reg, reusable across the
    predictor and corrector solves of one IPM iteration (same matrix)."""

    def __init__(self, M: np.ndarray, reg0: float):
        m = M.shape[0]
        tr = max(np.trace(M) / max(m, 1), 1.0)
        reg = reg0
        self.L = None
        self.M_reg = M
        for _ in range(6):
            M_reg = M + reg * tr * np.eye(m)
            try:
                self.L = np.linalg.cholesky(M_reg)
                return
            except np.linalg.LinAlgError:
                reg *= 100.0
        self.M_reg = M + reg * tr * np.eye(m)  # lstsq fallback operand

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        if self.L is not None:
            return np.linalg.solve(self.L.T, np.linalg.solve(self.L, rhs))
        return np.linalg.lstsq(self.M_reg, rhs, rcond=None)[0]


def _normal_matrix(As: np.ndarray, d: np.ndarray, n_slack: int,
                   slack_diag: np.ndarray | None) -> np.ndarray:
    """A D A^T, exploiting the slack identity block when present.

    With columns [A_core | slack] where slack column i has its single nonzero
    at row i, the product splits into a core matmul (m^2 * n_core flops
    instead of m^2 * n_std) plus a diagonal update on the slack rows.
    """
    if n_slack == 0:
        AD = As * d[None, :]
        return AD @ As.T
    nc = As.shape[1] - n_slack
    core = As[:, :nc]
    M = (core * d[None, :nc]) @ core.T
    sl = np.arange(n_slack)
    M[sl, sl] += slack_diag * slack_diag * d[nc:]
    return M


def solve_standard_form(
    A: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    *,
    tol: float = 1e-9,
    max_iter: int = 100,
    n_slack: int = 0,
) -> tuple[np.ndarray, str, int, float, float, float]:
    """Mehrotra predictor-corrector on  min c@x s.t. A@x=b, x>=0.

    n_slack: the trailing ``n_slack`` columns of A form an identity slack
    block attached to rows 0..n_slack (as produced by ``solve_lp``); the
    normal-equation assembly then skips the m^2 * n_slack flops those columns
    would otherwise cost.
    """
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    m, n = A.shape
    if m == 0:
        # unconstrained positive orthant: optimum at 0 if c >= 0
        return np.zeros(n), "optimal", 0, 0.0, 0.0, 0.0

    # Dependent equality rows (pruned graphs / fixed-N refits produce them)
    # are tolerated by the regularized normal-equation solves below, so no
    # explicit rank filtering is needed on the hot path.

    # Scaling: As = A / (rsc ⊗ csc), x_scaled = csc * x, so b_s = b / rsc and
    # the objective keeps its value with c_s = c / csc.
    As, rsc, csc = _ruiz_equilibrate(A)
    bs = b / rsc
    cs = c / csc
    # diagonal scaling keeps the slack block diagonal: entry (i, n-n_slack+i)
    slack_diag = (
        As[np.arange(n_slack), n - n_slack + np.arange(n_slack)]
        if n_slack
        else None
    )

    bnorm = 1.0 + np.linalg.norm(bs)
    cnorm = 1.0 + np.linalg.norm(cs)

    # ---- Mehrotra starting point
    AAt = _normal_matrix(As, np.ones(n), n_slack, slack_diag)
    tr = max(np.trace(AAt) / m, 1.0)
    AAt_reg = AAt + 1e-10 * tr * np.eye(m)
    try:
        x0 = As.T @ np.linalg.solve(AAt_reg, bs)
        y = np.linalg.solve(AAt_reg, As @ cs)
    except np.linalg.LinAlgError:
        x0 = As.T @ np.linalg.lstsq(AAt_reg, bs, rcond=None)[0]
        y = np.linalg.lstsq(AAt_reg, As @ cs, rcond=None)[0]
    s0 = cs - As.T @ y
    dx = max(-1.5 * x0.min(initial=0.0), 0.0)
    ds = max(-1.5 * s0.min(initial=0.0), 0.0)
    x = x0 + dx
    s = s0 + ds
    xs = float(x @ s)
    if xs <= 0:
        x = np.ones(n)
        s = np.ones(n)
        xs = float(n)
    x = x + 0.5 * xs / max(s.sum(), _EPS)
    s = s + 0.5 * xs / max(x.sum(), _EPS)
    x = np.maximum(x, 1e-4)
    s = np.maximum(s, 1e-4)

    status = "max_iter"
    it = 0
    best_pres = np.inf
    stall = 0
    best_gap = np.inf
    floor_stall = 0
    for it in range(1, max_iter + 1):
        rb = As @ x - bs
        rc = As.T @ y + s - cs
        mu = float(x @ s) / n
        pres = np.linalg.norm(rb) / bnorm
        dres = np.linalg.norm(rc) / cnorm
        gap = n * mu / (1.0 + abs(float(cs @ x)))
        if pres < tol and dres < tol and gap < tol:
            status = "optimal"
            break
        # floor acceptance: once all residuals sit below the relaxed 1e-7
        # threshold (which the post-loop check would accept anyway) and the
        # gap has stopped halving, further iterations only burn flops — the
        # solve has hit its numerical floor for this scaling.
        if gap < best_gap * 0.5:
            best_gap = gap
            floor_stall = 0
        else:
            floor_stall += 1
        if (pres < 1e-7 and dres < 1e-7 and gap < 1e-7 and floor_stall >= 5):
            status = "optimal"
            break
        # stall detection: primal residual stopped improving while still far
        # from feasible => (numerically) infeasible instance, bail early.
        # Stalls in the (1e-6, 1e-5) band are near-degenerate boundary
        # instances, not proofs of infeasibility: report max_iter and let
        # the caller's acceptance logic judge the returned point.
        if pres < best_pres * 0.9:
            best_pres = pres
            stall = 0
        else:
            stall += 1
            if stall >= 12 and pres > 1e-6:
                status = "infeasible" if pres > 1e-5 else "max_iter"
                break

        d = x / s
        # one factorization serves both the predictor and corrector solves
        factor = _NormalFactor(_normal_matrix(As, d, n_slack, slack_diag), 1e-12)

        # predictor (affine) step
        r_xs = x * s
        rhs = -rb - As @ (d * rc - r_xs / s)
        dy_aff = factor.solve(rhs)
        dx_aff = d * (As.T @ dy_aff + rc) - r_xs / s
        ds_aff = -(r_xs + s * dx_aff) / x

        a_pri = _max_step(x, dx_aff)
        a_dua = _max_step(s, ds_aff)
        mu_aff = float((x + a_pri * dx_aff) @ (s + a_dua * ds_aff)) / n
        sigma = float(np.clip((mu_aff / max(mu, _EPS)) ** 3, 0.0, 1.0))

        # corrector step
        r_xs = x * s + dx_aff * ds_aff - sigma * mu
        rhs = -rb - As @ (d * rc - r_xs / s)
        dy = factor.solve(rhs)
        dx = d * (As.T @ dy + rc) - r_xs / s
        dsv = -(r_xs + s * dx) / x

        eta = min(0.999, 0.9 + 0.09 * it / max_iter)
        a_pri = eta * _max_step(x, dx)
        a_dua = eta * _max_step(s, dsv)
        x = x + a_pri * dx
        y = y + a_dua * dy
        s = s + a_dua * dsv
        x = np.maximum(x, _EPS)
        s = np.maximum(s, _EPS)

    rb = As @ x - bs
    rc = As.T @ y + s - cs
    mu = float(x @ s) / n
    pres = float(np.linalg.norm(rb) / bnorm)
    dres = float(np.linalg.norm(rc) / cnorm)
    gap = float(n * mu / (1.0 + abs(float(cs @ x))))
    if status != "optimal":
        if pres < 1e-7 and dres < 1e-7 and gap < 1e-7:
            status = "optimal"
        elif pres > 1e-4:
            status = "infeasible"
    x_orig = x / csc
    return x_orig, status, it, gap, pres, dres


def _max_step(v: np.ndarray, dv: np.ndarray) -> float:
    neg = dv < 0
    if not neg.any():
        return 1.0
    return float(min(1.0, np.min(-v[neg] / dv[neg])))


def solve_lp(
    c: np.ndarray,
    A_ub: np.ndarray,
    b_ub: np.ndarray,
    A_eq: np.ndarray,
    b_eq: np.ndarray,
    *,
    tol: float = 1e-9,
    max_iter: int = 100,
) -> IPMResult:
    """Solve min c@x s.t. A_ub@x<=b_ub, A_eq@x=b_eq, x>=0 by adding slacks."""
    c = np.asarray(c, dtype=np.float64)
    n = c.shape[0]
    m_ub = A_ub.shape[0] if A_ub is not None and A_ub.size else 0
    m_eq = A_eq.shape[0] if A_eq is not None and A_eq.size else 0
    n_std = n + m_ub
    A = np.zeros((m_ub + m_eq, n_std))
    b = np.zeros(m_ub + m_eq)
    if m_ub:
        A[:m_ub, :n] = A_ub
        A[:m_ub, n:] = np.eye(m_ub)
        b[:m_ub] = b_ub
    if m_eq:
        A[m_ub:, :n] = A_eq
        b[m_ub:] = b_eq
    c_std = np.concatenate([c, np.zeros(m_ub)])
    x, status, it, gap, pres, dres = solve_standard_form(
        A, b, c_std, tol=tol, max_iter=max_iter, n_slack=m_ub
    )
    return IPMResult(
        x=x[:n],
        fun=float(c @ x[:n]),
        status=status,
        iterations=it,
        gap=gap,
        primal_residual=pres,
        dual_residual=dres,
    )
