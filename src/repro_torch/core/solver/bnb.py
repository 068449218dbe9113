"""MILP solving for Skyplane plans: exact branch & bound and the paper's
continuous relaxation + round-down (§5.1.3).

The paper's observation: relaxing N (VMs) and M (TCP connections) to reals and
rounding *down* performs within ~1% of the exact MILP. Procedure implemented
here (``mode="relaxed"``):

  1. solve the LP relaxation;
  2. floor N; if the throughput goal became unreachable, bump the regions with
     the largest fractional parts back up (feasibility repair);
  3. with N fixed, re-solve for (F, M); floor M, then greedily hand leftover
     per-region connection budget back to the highest-capacity active edges
     (restores most of the capacity the floor gave up);
  4. with N and M fixed, re-fit F: max-flow probe, then a min-cost solve at
     ``min(goal, maxflow)``. The achieved throughput (>= ~99% of the goal,
     matching the paper's <=1% optimality gap) is reported alongside the plan.

``mode="exact"`` wraps the same integerization in a best-first branch & bound
on N (the only integer variables with objective weight; M is integerized per
node as above).

Every step derives its LP from the cached ``milp.LPStructure`` — one
vectorized assembly per (topology, src, dst), O(rows) per variant — and
``solve_milp_batched`` runs the whole round-down pipeline for a *batch* of
throughput goals through a batched IPM engine (stage-by-stage: root
relaxations, feasibility-repair candidate probes, fixed-N refits, fixed-N+M
refits — each one batched call over RHS variants, with per-sample numpy
fallback on KKT failure). The planner's ``backend="torch"`` runs it on the
torch IPM (``ipm_torch``) on the card.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math

import numpy as np

from .. import milp
from ..topology import GBIT_PER_GB
from .ipm import solve_lp

_INT_TOL = 1e-6


@dataclasses.dataclass
class MILPResult:
    F: np.ndarray  # [V,V] Gbit/s
    N: np.ndarray  # [V] ints
    M: np.ndarray  # [V,V] ints
    objective: float  # $/s while the transfer runs (unscaled Eq. 4a)
    status: str
    lp_objective: float  # relaxation bound
    achieved_tput: float = 0.0  # Gbit/s the integral plan actually provides
    nodes_explored: int = 1

    @property
    def ok(self) -> bool:
        return self.status == "optimal"


def _empty(top, status: str, lp_obj: float = math.inf, nodes: int = 1) -> MILPResult:
    v = top.num_regions
    z = np.zeros((v, v))
    return MILPResult(
        F=z, N=np.zeros(v), M=z.copy(), objective=math.inf, status=status,
        lp_objective=lp_obj, nodes_explored=nodes,
    )


def _topup_connections(top, M_frac: np.ndarray, M_int: np.ndarray, n_int: np.ndarray):
    """Greedily spend leftover per-region connection budget on the edges the
    floor hurt most (largest per-connection capacity first). In place."""
    out_budget = top.limit_conn * n_int - M_int.sum(axis=1)
    in_budget = top.limit_conn * n_int - M_int.sum(axis=0)
    frac = M_frac - np.floor(M_frac + _INT_TOL)
    cand = [
        (u, w)
        for u, w in zip(*np.where(frac > 1e-4))
    ]
    # highest capacity-per-connection edges first
    cand.sort(key=lambda e: -top.tput[e[0], e[1]])
    for u, w in cand:
        if out_budget[u] >= 1 and in_budget[w] >= 1:
            M_int[u, w] += 1
            out_budget[u] -= 1
            in_budget[w] -= 1


def _cuts_resolved_by_n(struct: milp.LPStructure, extra_ub, n_int):
    """B&B cuts only touch N columns; once N is pinned they are constants.

    Returns True (all satisfied: rows droppable), False (violated:
    infeasible), or None (a cut touches free variables: keep the rows)."""
    e, v = struct.n_edges, struct.num_regions
    n_int = np.asarray(n_int, dtype=float)
    for row, b in extra_ub:
        row = np.asarray(row, dtype=float)
        outside = np.abs(np.delete(row, np.s_[e : e + v])).max(initial=0.0)
        if outside > 1e-12:
            return None
        if row[e : e + v] @ n_int > b + 1e-9:
            return False
    return True


def _resolve_cuts(struct, fixed_n, extra_ub):
    """(extra_ub', infeasible) after evaluating N-only cuts against fixed_n."""
    if fixed_n is None or not extra_ub:
        return extra_ub, False
    res = _cuts_resolved_by_n(struct, extra_ub, fixed_n)
    if res is None:
        return extra_ub, False
    return None, not res


def _reduction(struct: milp.LPStructure, fixed_n, fixed_m=None):
    """Route a pinned solve to its exact presolve (milp.LPStructure.reduced).

    Returns "identity" when nothing shrinks, None when the reduction proves
    the instance carries no flow, else (rstruct, keep, reduced_n, reduced_m).
    """
    support = np.asarray(fixed_n) > 0
    edge_mask = None if fixed_m is None else np.asarray(fixed_m) > 0
    if support.all() and (
        edge_mask is None or edge_mask[struct.eu, struct.ew].all()
    ):
        return "identity"
    red = struct.reduced(support, edge_mask)
    if red is None:
        return None
    rstruct, keep = red
    rn = np.asarray(fixed_n, dtype=float)[keep]
    rM = (
        None if fixed_m is None
        else np.asarray(fixed_m, dtype=float)[np.ix_(keep, keep)]
    )
    return rstruct, keep, rn, rM


def _max_flow(struct: milp.LPStructure, *, fixed_n=None, fixed_m=None,
              extra_ub=None) -> float:
    """Max source outflow with the given allocations pinned. This LP is always
    feasible (F=0 works), so the IPM never grinds on an infeasible instance —
    the round-down pipeline is built exclusively from max-flow probes followed
    by min-cost solves at a known-achievable goal."""
    extra_ub, infeasible = _resolve_cuts(struct, fixed_n, extra_ub)
    if infeasible:
        return 0.0
    if fixed_n is not None and extra_ub is None:
        red = _reduction(struct, fixed_n, fixed_m)
        if red is None:
            return 0.0
        if red != "identity":
            rstruct, _, rn, rM = red
            return _max_flow(rstruct, fixed_n=rn, fixed_m=rM)
    return _max_flow_raw(struct, fixed_n=fixed_n, fixed_m=fixed_m,
                         extra_ub=extra_ub)


def _max_flow_raw(struct: milp.LPStructure, *, fixed_n=None, fixed_m=None,
                  extra_ub=None) -> float:
    lp = struct.lp(0.0, fixed_n=fixed_n, fixed_m=fixed_m, extra_ub=extra_ub)
    if lp.trivially_infeasible:
        return 0.0
    c_out = struct.outflow_c(
        struct.pin_pattern(fixed_n is not None, fixed_m is not None)
    )
    res = solve_lp(c_out, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq)
    out = max(float(-(c_out @ res.x)), 0.0)
    if res.ok:
        return out
    # near-converged probe on an always-feasible LP (degenerate refit
    # instances can stall the IPM just above its acceptance threshold with
    # a tiny duality gap): the outflow is still a valid bound once shaded
    # down by the remaining primal infeasibility.
    if (res.status == "max_iter" and res.primal_residual < 1e-5
            and res.gap < 1e-6):
        return out * (1.0 - 10.0 * res.primal_residual)
    return 0.0


def _min_cost_fit(struct: milp.LPStructure, goal: float, n_int: np.ndarray,
                  M_int: np.ndarray, extra_ub=None) -> np.ndarray | None:
    """Min-cost F with N and M pinned (the final §5.1.3 refit)."""
    extra_ub, infeasible = _resolve_cuts(struct, n_int, extra_ub)
    if infeasible:
        return None
    if extra_ub is None:
        red = _reduction(struct, n_int, M_int)
        if red is None:
            return None
        if red != "identity":
            rstruct, keep, rn, rM = red
            rF = _min_cost_fit(rstruct, goal, rn, rM)
            if rF is None:
                return None
            F = np.zeros((struct.num_regions,) * 2)
            F[np.ix_(keep, keep)] = rF
            return F
    lp = struct.lp(goal, fixed_n=n_int, fixed_m=M_int, extra_ub=extra_ub)
    if lp.trivially_infeasible:
        return None
    res = solve_lp(lp.c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq)
    if not _near_ok(res):
        return None
    F, _, _ = lp.split(res.x)
    return F


def _near_ok(res) -> bool:
    """Refits run at achieved == maxflow*(1-1e-9): essentially on the
    feasibility boundary, where degenerate instances can stall the IPM a
    hair above its acceptance threshold. A near-converged solution (tiny
    gap/dual residual, primal violation ~1e-6 relative) is still a valid
    plan within TransferPlan.validate()'s tolerance."""
    return res.ok or (
        res.status == "max_iter" and res.primal_residual < 1e-5
        and res.dual_residual < 1e-6 and res.gap < 1e-6
    )


def _integerize(struct: milp.LPStructure, tput_goal: float, n_int: np.ndarray,
                extra_ub=None):
    """Steps 3-4 above. Returns (F, M_int, achieved, obj) or None."""
    extra_ub, infeasible = _resolve_cuts(struct, n_int, extra_ub)
    if infeasible:
        return None
    if extra_ub is None:
        red = _reduction(struct, n_int)
        if red is None:
            return None
        if red != "identity":
            rstruct, keep, rn, _ = red
            fit = _integerize(rstruct, tput_goal, rn)
            if fit is None:
                return None
            rF, rM, achieved, obj = fit
            v = struct.num_regions
            F = np.zeros((v, v))
            M = np.zeros((v, v))
            F[np.ix_(keep, keep)] = rF
            M[np.ix_(keep, keep)] = rM
            return F, M, achieved, obj
    top = struct.top
    goal_n = min(tput_goal, _max_flow(struct, fixed_n=n_int, extra_ub=extra_ub)
                 * (1.0 - 1e-9))
    if goal_n <= 0:
        return None
    lp = struct.lp(goal_n, fixed_n=n_int, extra_ub=extra_ub)
    if lp.trivially_infeasible:
        return None
    res = solve_lp(lp.c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq)
    if not _near_ok(res):
        return None
    _, _, M_frac = lp.split(res.x)
    M_int = np.floor(M_frac + _INT_TOL)
    _topup_connections(top, M_frac, M_int, n_int)

    # re-fit F with both integer allocations pinned at what they can carry
    maxflow = _max_flow(struct, fixed_n=n_int, fixed_m=M_int, extra_ub=extra_ub)
    achieved = min(goal_n, maxflow * (1.0 - 1e-9))
    if achieved <= 0:
        return None
    F = _min_cost_fit(struct, achieved, n_int, M_int, extra_ub)
    if F is None:
        return None
    obj = float((F * top.price_egress).sum() / GBIT_PER_GB + n_int @ top.price_vm)
    return F, M_int, achieved, obj


def _repair_candidates(n_frac: np.ndarray, limit_vm: float) -> np.ndarray:
    """The round-down repair ladder: floor, then cumulative +1 bumps in
    descending-fractional-part order, then ceil. [V+2, V]."""
    n_floor = np.floor(n_frac + _INT_TOL)
    order = np.argsort(-(n_frac - n_floor))
    cands = [n_floor]
    cur = n_floor
    for r in order:
        cur = cur.copy()
        cur[r] = min(cur[r] + 1, limit_vm)
        cands.append(cur)
    cands.append(np.minimum(np.ceil(n_frac - _INT_TOL), limit_vm))
    return np.stack(cands)


def _feasible_with_n(struct, tput_goal, n_int, extra_ub=None) -> bool:
    return _max_flow(struct, fixed_n=n_int, extra_ub=extra_ub) >= tput_goal * (
        1.0 - 1e-6
    )


def _feasibility_repair(
    struct, tput_goal, n_frac: np.ndarray, extra_ub=None
) -> np.ndarray | None:
    """Floor N, then bump regions (largest fractional part first) until the
    goal throughput is reachable again."""
    for n_try in _repair_candidates(n_frac, struct.top.limit_vm):
        if _feasible_with_n(struct, tput_goal, n_try, extra_ub):
            return n_try
    return None


def solve_milp(
    top,
    src: int,
    dst: int,
    tput_goal: float,
    *,
    mode: str = "relaxed",
    max_nodes: int = 60,
    backend: str = "numpy",
    extra_ub=None,
    device=None,
) -> MILPResult:
    """Solve one (src, dst, tput_goal) instance.

    backend="torch" routes the relaxed round-down through the batched torch
    IPM on ``device`` (one-sample batches; None = the card). The exact
    branch & bound always runs on the numpy reference solver.

    extra_ub: extra inequality rows in the full [F, N, M] variable space,
    threaded through every stage of the round-down (and merged with the
    B&B's own bound cuts in exact mode). This is how degraded-topology
    re-planning constrains the cached LPStructure — tightened 4b rows for
    degraded links, N caps for unhealthy regions — without re-assembling
    anything. Constrained solves run on the sequential numpy path (the
    batched pipeline shares matrices across samples and does not take
    per-instance rows).
    """
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r} (use numpy or torch)")
    if backend == "torch" and mode == "relaxed" and not extra_ub:
        return solve_milp_batched(
            top, src, dst, np.array([tput_goal]), engine="torch",
            device=device,
        )[0]
    base_cuts = list(extra_ub) if extra_ub else None
    struct = milp.structure(top, src, dst)
    lp = struct.lp(tput_goal, extra_ub=base_cuts)
    root = solve_lp(lp.c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq)
    if not root.ok:
        return _empty(top, root.status)
    _, n_frac, _ = lp.split(root.x)

    def round_down(n_source: np.ndarray, extra_ub=None) -> MILPResult | None:
        n_int = _feasibility_repair(struct, tput_goal, n_source, extra_ub)
        if n_int is None:
            return None
        fit = _integerize(struct, tput_goal, n_int, extra_ub)
        if fit is None:
            return None
        F, M, achieved, obj = fit
        return MILPResult(
            F=F, N=n_int.astype(np.int64), M=M.astype(np.int64),
            objective=obj, status="optimal", lp_objective=root.fun,
            achieved_tput=achieved,
        )

    if mode == "relaxed":
        out = round_down(n_frac, base_cuts)
        return out if out is not None else _empty(top, "infeasible", root.fun)

    if mode != "exact":
        raise ValueError(f"unknown mode {mode!r}")

    # ---------------- best-first branch & bound over N ----------------
    v = top.num_regions
    e = lp.n_edges

    def n_col(r: int) -> np.ndarray:
        row = np.zeros(2 * e + v)
        row[e + r] = 1.0
        return row

    best: MILPResult | None = round_down(n_frac, base_cuts)  # incumbent
    best_obj = best.objective if best is not None else math.inf

    counter = itertools.count()
    heap: list[tuple[float, int, list]] = [(root.fun, next(counter), [])]
    nodes = 0
    while heap and nodes < max_nodes:
        bound, _, cuts = heapq.heappop(heap)
        if bound >= best_obj - 1e-9:
            continue
        nodes += 1
        extra = list(base_cuts) if base_cuts else []
        for r, sense, val in cuts:
            col = n_col(r)
            if sense == "<=":
                extra.append((col, float(val)))
            else:  # N_r >= val
                extra.append((-col, -float(val)))
        if cuts:
            node_lp = struct.lp(tput_goal, extra_ub=extra)
            res = solve_lp(node_lp.c, node_lp.A_ub, node_lp.b_ub,
                           node_lp.A_eq, node_lp.b_eq)
        else:  # the cut-free node IS the root relaxation: reuse it
            node_lp, res = lp, root
        if not res.ok or res.fun >= best_obj - 1e-9:
            continue
        _, n_node, _ = node_lp.split(res.x)
        frac = n_node - np.floor(n_node + _INT_TOL)
        frac_ix = np.where(frac > 1e-4)[0]
        if frac_ix.size == 0:
            n_int = np.round(n_node).astype(float)
            fit = _integerize(struct, tput_goal, n_int, extra)
            if fit is not None and fit[3] < best_obj:
                F, M, achieved, obj = fit
                best_obj = obj
                best = MILPResult(
                    F=F, N=n_int.astype(np.int64), M=M.astype(np.int64),
                    objective=obj, status="optimal", lp_objective=root.fun,
                    achieved_tput=achieved, nodes_explored=nodes,
                )
            continue
        r = int(frac_ix[np.argmax(frac[frac_ix])])
        lo = math.floor(n_node[r] + _INT_TOL)
        heapq.heappush(heap, (res.fun, next(counter), cuts + [(r, "<=", lo)]))
        heapq.heappush(heap, (res.fun, next(counter), cuts + [(r, ">=", lo + 1)]))

    if best is None:
        return _empty(top, "infeasible", root.fun, nodes)
    best.nodes_explored = nodes
    return best


# ------------------------------------------------------------------ multicast
@dataclasses.dataclass
class MulticastMILPResult:
    """Round-down result of the multicast MILP (one source, D commodities)."""

    G: np.ndarray  # [V,V] envelope Gbit/s — what egress is billed on
    F: np.ndarray  # [D,V,V] per-commodity Gbit/s
    N: np.ndarray  # [V] ints
    M: np.ndarray  # [V,V] ints
    objective: float  # $/s while the transfer runs
    status: str
    lp_objective: float
    achieved_goals: np.ndarray  # [D] Gbit/s the integral plan provides
    scale: float = 0.0  # uniform fraction of the requested goals achieved

    @property
    def ok(self) -> bool:
        return self.status == "optimal"


def _mc_empty(top, n_dsts: int, status: str,
              lp_obj: float = math.inf) -> MulticastMILPResult:
    v = top.num_regions
    return MulticastMILPResult(
        G=np.zeros((v, v)), F=np.zeros((n_dsts, v, v)), N=np.zeros(v),
        M=np.zeros((v, v)), objective=math.inf, status=status,
        lp_objective=lp_obj, achieved_goals=np.zeros(n_dsts),
    )


def _mc_reduction(struct, fixed_n, allow_build: bool = True):
    """Exact presolve routing for pinned multicast solves.

    Returns "identity" when every region is live (or the solve must run
    full-size), else (rstruct, keep, rn) — src and all destinations are
    force-kept by ``reduced`` — or None when the reduction has no edges
    left. ``allow_build=False`` (constrained re-plans) only ever REUSES a
    cached reduction: a cold support solves full-size rather than
    assembling anything mid-replan."""
    support = np.asarray(fixed_n) > 0
    support = support.copy()
    support[[struct.src, *struct.dsts]] = True
    if support.all():
        return "identity"
    if allow_build:
        red = struct.reduced(support)
    else:
        red = struct.reduced_cached(support)
        if red == "miss":
            return "identity"
    if red is None:
        return None
    rstruct, keep = red
    return rstruct, keep, np.asarray(fixed_n, dtype=float)[keep]


def _mc_map_cuts(struct, rstruct, keep, extra_ub):
    """Map extra_ub rows from ``struct``'s variable space into a reduced
    structure's. Exact: a dropped region has N pinned to 0, which forces
    every G/F/M variable on its edges to 0 (4f-4i), so dropped columns
    contribute nothing — kept columns are re-indexed, dropped ones vanish.
    Rows that become all-zero are handled by the RHS-shift machinery."""
    if not extra_ub:
        return extra_ub
    inv = {int(r): i for i, r in enumerate(keep)}
    redge_ix = {e: i for i, e in enumerate(rstruct.edges)}
    e_full, e_red = struct.n_edges, rstruct.n_edges
    D = struct.n_dsts
    kept_k, red_k = [], []
    for k, (u, w) in enumerate(struct.edges):
        ru, rw = inv.get(u), inv.get(w)
        if ru is not None and rw is not None and (ru, rw) in redge_ix:
            kept_k.append(k)
            red_k.append(redge_ix[(ru, rw)])
    kept_k = np.asarray(kept_k, dtype=np.int64)
    red_k = np.asarray(red_k, dtype=np.int64)
    kept_r = np.asarray(sorted(inv), dtype=np.int64)
    red_r = np.asarray([inv[int(r)] for r in kept_r], dtype=np.int64)
    out = []
    for row, b in extra_ub:
        row = np.asarray(row, dtype=float)
        nrow = np.zeros(rstruct.nx)
        for blk in range(1 + D):  # G then each commodity
            nrow[blk * e_red + red_k] = row[blk * e_full + kept_k]
        nrow[rstruct.iN + red_r] = row[struct.iN + kept_r]
        nrow[rstruct.iM + red_k] = row[struct.iM + kept_k]
        out.append((nrow, float(b)))
    return out


def _mc_scale_probe(struct, goals, *, fixed_n=None, fixed_m=None,
                    extra_ub=None, cap: float | None = 1.0) -> float:
    """Max uniform scale t with deliveries >= t * goal_d (see
    MulticastLPStructure.probe_lp). Returns 0.0 on failure."""
    if float(np.max(goals, initial=0.0)) <= 0.0:
        return cap if cap is not None else math.inf
    if fixed_n is not None:
        red = _mc_reduction(struct, fixed_n, allow_build=not extra_ub)
        if red is None:
            return 0.0
        if red != "identity":
            rstruct, keep, rn = red
            rM = (None if fixed_m is None
                  else np.asarray(fixed_m)[np.ix_(keep, keep)])
            return _mc_scale_probe(
                rstruct, goals, fixed_n=rn, fixed_m=rM,
                extra_ub=_mc_map_cuts(struct, rstruct, keep, extra_ub),
                cap=cap,
            )
    probe = struct.probe_lp(goals, fixed_n=fixed_n, fixed_m=fixed_m,
                            extra_ub=extra_ub, cap=cap)
    if probe is None:
        return 0.0
    c, A_ub, b_ub, A_eq, b_eq = probe
    res = solve_lp(c, A_ub, b_ub, A_eq, b_eq)
    t = max(float(-(c @ res.x)), 0.0)
    if res.ok:
        return t
    if (res.status == "max_iter" and res.primal_residual < 1e-5
            and res.gap < 1e-6):
        return t * (1.0 - 10.0 * res.primal_residual)
    return 0.0


def _mc_min_cost(struct, goals, *, fixed_n=None, fixed_m=None, extra_ub=None):
    """Min-cost multicast solve at known-achievable goals; None on failure.

    Returns ((G, F, N, M) in ``struct``'s full region space, objective)."""
    if fixed_n is not None:
        red = _mc_reduction(struct, fixed_n, allow_build=not extra_ub)
        if red is None:
            return None
        if red != "identity":
            rstruct, keep, rn = red
            rM = (None if fixed_m is None
                  else np.asarray(fixed_m)[np.ix_(keep, keep)])
            fit = _mc_min_cost(
                rstruct, goals, fixed_n=rn, fixed_m=rM,
                extra_ub=_mc_map_cuts(struct, rstruct, keep, extra_ub),
            )
            if fit is None:
                return None
            (rG, rF, rN, rMM), fun = fit
            v = struct.num_regions
            G = np.zeros((v, v))
            F = np.zeros((len(struct.dsts), v, v))
            N = np.zeros(v)
            M = np.zeros((v, v))
            G[np.ix_(keep, keep)] = rG
            F[np.ix_(np.arange(len(struct.dsts)), keep, keep)] = rF
            N[keep] = rN
            M[np.ix_(keep, keep)] = rMM
            return (G, F, N, M), fun
    lp = struct.lp(goals, fixed_n=fixed_n, fixed_m=fixed_m, extra_ub=extra_ub)
    if lp.trivially_infeasible:
        return None
    res = solve_lp(lp.c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq)
    if not _near_ok(res):
        return None
    return lp.split(res.x), float(res.fun)


def solve_multicast(
    top,
    src: int,
    dsts,
    goals,
    *,
    extra_ub=None,
) -> MulticastMILPResult:
    """§5.1.3 round-down for the multicast MILP: one source, a commodity per
    destination, egress billed once on the shared envelope.

    Same pipeline shape as the unicast ``solve_milp``: root relaxation ->
    floor N + feasibility-repair ladder -> fixed-N refit + connection
    floor/top-up -> fixed-N+M refit — except the max-flow probes become
    uniform-scale probes (max t with every commodity delivering t * goal_d),
    which are always-feasible LPs. Every solve derives O(rows) from the
    cached ``milp.MulticastLPStructure``; ``extra_ub`` rows (degraded links,
    VM caps) ride on it without any re-assembly.
    """
    dsts = tuple(int(d) for d in dsts)
    goals = np.asarray(goals, dtype=float)
    if goals.ndim == 0:
        goals = np.full(len(dsts), float(goals))
    if goals.shape != (len(dsts),):
        raise ValueError(f"need one goal per destination, got {goals.shape}")
    struct = milp.multicast_structure(top, src, dsts)
    v = struct.num_regions

    if float(goals.max(initial=0.0)) <= 0.0:
        out = _mc_empty(top, len(dsts), "optimal", 0.0)
        out.objective = 0.0
        out.scale = 1.0
        return out

    # ---- root relaxation
    lp = struct.lp(goals, extra_ub=extra_ub)
    if lp.trivially_infeasible:
        return _mc_empty(top, len(dsts), "infeasible")
    root = solve_lp(lp.c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq)
    if not _near_ok(root):
        return _mc_empty(top, len(dsts), root.status)
    _, _, n_frac, _ = lp.split(root.x)

    # ---- feasibility repair: floor N, bump until the goals are reachable
    n_int, t1 = None, 0.0
    for n_try in _repair_candidates(n_frac, top.limit_vm):
        t = _mc_scale_probe(struct, goals, fixed_n=n_try, extra_ub=extra_ub)
        if t >= 1.0 - 1e-6:
            n_int, t1 = n_try, t
            break
    if n_int is None:
        return _mc_empty(top, len(dsts), "infeasible", root.fun)

    # ---- fixed-N refit: fractional M at the probed-achievable goals
    fit = _mc_min_cost(struct, goals * min(1.0, t1) * (1.0 - 1e-9),
                       fixed_n=n_int, extra_ub=extra_ub)
    if fit is None:
        return _mc_empty(top, len(dsts), "infeasible", root.fun)
    (_, _, _, M_frac), _ = fit
    M_int = np.floor(M_frac + _INT_TOL)
    _topup_connections(top, M_frac, M_int, n_int)

    # ---- fixed-N+M: probe the residual scale, refit G and F at it
    t2 = _mc_scale_probe(struct, goals, fixed_n=n_int, fixed_m=M_int,
                         extra_ub=extra_ub)
    scale = min(1.0, t2) * (1.0 - 1e-9)
    if scale <= 0.0:
        return _mc_empty(top, len(dsts), "infeasible", root.fun)
    achieved = goals * scale
    fit = _mc_min_cost(struct, achieved, fixed_n=n_int, fixed_m=M_int,
                       extra_ub=extra_ub)
    if fit is None:
        return _mc_empty(top, len(dsts), "infeasible", root.fun)
    (G, F, _, _), _ = fit
    # commodity flows are free in the objective (only the envelope is
    # billed), so a zero-goal commodity can come back carrying junk flow —
    # scrub it, or a finished destination would re-enter the trees
    F[achieved <= 0.0] = 0.0
    obj = float((G * top.price_egress).sum() / GBIT_PER_GB
                + n_int @ top.price_vm)
    return MulticastMILPResult(
        G=G, F=F, N=n_int.astype(np.int64), M=M_int.astype(np.int64),
        objective=obj, status="optimal", lp_objective=float(root.fun),
        achieved_goals=achieved, scale=float(scale),
    )


# --------------------------------------------------------------------- batched
def solve_milp_batched(
    top,
    src: int,
    dst: int,
    goals: np.ndarray,
    *,
    iters: int = 40,
    engine: str = "numpy",
    device=None,
) -> list[MILPResult]:
    """The §5.1.3 round-down pipeline for a batch of throughput goals.

    Replays the exact sequential procedure (root relaxation -> feasibility
    repair -> fixed-N refit + connection top-up -> fixed-N+M refit) but runs
    each stage as ONE batched IPM call across all still-live goals: the
    LPs of a stage share their matrices (cached pin patterns of the
    LPStructure) and differ only in RHS shifts. Samples whose batched solve
    fails its KKT check are transparently re-solved by the numpy IPM, so the
    result list matches the sequential path's answers. ``engine`` names the
    batched engine (ipm_batch: "numpy" stacked LAPACK, or "torch", the
    batched torch IPM on ``device``, None = the card).
    """
    from .ipm_batch import solve_lp_batched_with_fallback

    struct = milp.structure(top, src, dst)
    goals = np.asarray(goals, dtype=float)
    B = len(goals)
    v, e = struct.num_regions, struct.n_edges
    eu, ew = struct.eu, struct.ew
    results: list[MILPResult | None] = [None] * B

    def finish():
        return [
            results[i] if results[i] is not None
            else _empty(top, "infeasible",
                        root_fun[i] if root_ok[i] else math.inf)
            for i in range(B)
        ]

    # ---- stage 0: root relaxations (batch over the two goal rows of b)
    b0 = np.tile(struct.b_ub0[None, :], (B, 1))
    b0[:, struct.row_4c] = -goals
    b0[:, struct.row_4d] = -goals
    x0, root_fun, root_ok, _ = solve_lp_batched_with_fallback(
        struct.c, struct.A_ub, b0, struct.A_eq, struct.b_eq, iters=iters,
        engine=engine, device=device,
    )
    alive = root_ok.copy()
    n_frac = x0[:, e : e + v]
    if not alive.any():
        return finish()

    # Stages 1-4 pin N (and later M), so every solve routes through the exact
    # presolve: rows sharing a (support, edge-mask) reduction solve as one
    # batched call on the reduced structure.
    def grouped_pinned(goals_k, n_mat, M_mat, objective):
        """Batched pinned solves grouped by identical reduction.

        objective "outflow": returns (maxflow [K]).
        objective "cost":    returns (x_full [K, nx-ish as (F, M) grids], ok):
        F [K,v,v] always; M [K,v,v] only meaningful when M_mat is None.
        """
        K = n_mat.shape[0]
        maxflow = np.zeros(K)
        F_out = np.zeros((K, v, v))
        M_out = np.zeros((K, v, v))
        okv = np.zeros(K, dtype=bool)
        groups: dict[bytes, list[int]] = {}
        for k in range(K):
            key = (n_mat[k] > 0).tobytes()
            if M_mat is not None:
                key += (M_mat[k] > 0).tobytes()
            groups.setdefault(key, []).append(k)
        for rows in groups.values():
            r0 = rows[0]
            support = n_mat[r0] > 0
            edge_mask = None if M_mat is None else M_mat[r0] > 0
            if support.all() and (
                edge_mask is None or edge_mask[eu, ew].all()
            ):
                rstruct, keep = struct, np.arange(v)
            else:
                red = struct.reduced(support, edge_mask)
                if red is None:
                    continue  # provably zero flow: maxflow 0 / not ok
                rstruct, keep = red
            rn = n_mat[rows][:, keep]
            if M_mat is not None:
                rM = M_mat[np.ix_(rows, keep, keep)]
                pins = np.concatenate(
                    [rn, rM[:, rstruct.eu, rstruct.ew]], axis=1
                )
            else:
                pins = rn
            pat = rstruct.pin_pattern(True, M_mat is not None)
            stage_goals = (
                np.zeros(len(rows)) if objective == "outflow"
                else goals_k[rows]
            )
            b, triv = rstruct.batch_b_ub(pat, stage_goals, pins)
            c_stage = (
                rstruct.outflow_c(pat) if objective == "outflow"
                else pat.c_free
            )
            x, fun, ok, _ = solve_lp_batched_with_fallback(
                c_stage, pat.A_ub_free, b, pat.A_eq_free,
                rstruct.b_eq[pat.keep_eq], iters=iters, engine=engine,
                device=device,
            )
            good = ok & ~triv
            re = rstruct.n_edges
            for row_local, k in enumerate(rows):
                if not good[row_local]:
                    if triv[row_local]:
                        continue
                    # uncertified sample: retry on the tolerant sequential
                    # path (degenerate boundary refits; see _max_flow_raw)
                    rn_k = n_mat[k][keep]
                    rM_k = (None if M_mat is None
                            else M_mat[k][np.ix_(keep, keep)])
                    if objective == "outflow":
                        maxflow[k] = _max_flow_raw(
                            rstruct, fixed_n=rn_k, fixed_m=rM_k
                        )
                        okv[k] = True
                    elif M_mat is not None:
                        Fk = _min_cost_fit(rstruct, float(goals_k[k]),
                                           rn_k, rM_k)
                        if Fk is not None:
                            F_out[np.ix_([k], keep, keep)] = Fk[None]
                            okv[k] = True
                    else:
                        lp_k = rstruct.lp(float(goals_k[k]), fixed_n=rn_k)
                        if not lp_k.trivially_infeasible:
                            res_k = solve_lp(lp_k.c, lp_k.A_ub, lp_k.b_ub,
                                             lp_k.A_eq, lp_k.b_eq)
                            if _near_ok(res_k):
                                Fk, _, Mk = lp_k.split(res_k.x)
                                F_out[np.ix_([k], keep, keep)] = Fk[None]
                                M_out[np.ix_([k], keep, keep)] = Mk[None]
                                okv[k] = True
                    continue
                okv[k] = True
                if objective == "outflow":
                    maxflow[k] = max(-float(fun[row_local]), 0.0)
                else:
                    Fk = np.zeros((rstruct.num_regions,) * 2)
                    Fk[rstruct.eu, rstruct.ew] = x[row_local, :re]
                    F_out[np.ix_([k], keep, keep)] = Fk[None]
                    if M_mat is None:  # fixed-N solve: free cols are [F, M]
                        Mk = np.zeros((rstruct.num_regions,) * 2)
                        Mk[rstruct.eu, rstruct.ew] = x[row_local, re:]
                        M_out[np.ix_([k], keep, keep)] = Mk[None]
        if objective == "outflow":
            return maxflow
        return F_out, M_out, okv

    # ---- stage 1: feasibility repair — batched max-flow probes, two-phase:
    # floors first (usually enough), then the full bump ladder only for the
    # goals whose floor fell short. Matches the sequential first-feasible pick.
    live_ix = np.flatnonzero(alive)
    floors = np.floor(n_frac[live_ix] + _INT_TOL)
    mf_floor = grouped_pinned(None, floors, None, "outflow")
    n_int = np.zeros((B, v))
    flow_cap = np.zeros(B)
    need_ladder = []
    for row, i in enumerate(live_ix):
        if mf_floor[row] >= goals[i] * (1.0 - 1e-6):
            n_int[i] = floors[row]
            flow_cap[i] = mf_floor[row]
        else:
            need_ladder.append(i)
    if need_ladder:
        K = v + 1  # bump ladder + ceil (floor already probed)
        ladders = np.stack(
            [_repair_candidates(n_frac[i], top.limit_vm)[1:] for i in need_ladder]
        )
        mf = grouped_pinned(
            None, ladders.reshape(-1, v), None, "outflow"
        ).reshape(len(need_ladder), K)
        for row, i in enumerate(need_ladder):
            feas = np.flatnonzero(mf[row] >= goals[i] * (1.0 - 1e-6))
            if feas.size == 0:
                alive[i] = False
                continue
            k = int(feas[0])
            n_int[i] = ladders[row, k]
            flow_cap[i] = mf[row, k]
    if not alive.any():
        return finish()

    # ---- stage 2: fixed-N min-cost refit at min(goal, maxflow)
    goal_n = np.minimum(goals, flow_cap * (1.0 - 1e-9))
    alive &= goal_n > 0
    live_ix = np.flatnonzero(alive)
    if live_ix.size == 0:
        return finish()
    _, M_frac_all, ok2 = grouped_pinned(
        goal_n[live_ix], n_int[live_ix], None, "cost"
    )
    M_int = np.zeros((B, v, v))
    for row, i in enumerate(live_ix):
        if not ok2[row]:
            alive[i] = False
            continue
        M_frac = M_frac_all[row]
        Mi = np.floor(M_frac + _INT_TOL)
        _topup_connections(top, M_frac, Mi, n_int[i])
        M_int[i] = Mi
    live_ix = np.flatnonzero(alive)
    if live_ix.size == 0:
        return finish()

    # ---- stage 3: fixed-N+M max-flow probe
    maxflow3 = grouped_pinned(
        None, n_int[live_ix], M_int[live_ix], "outflow"
    )
    achieved = np.zeros(B)
    achieved[live_ix] = np.minimum(goal_n[live_ix], maxflow3 * (1.0 - 1e-9))
    alive &= achieved > 0
    live_ix = np.flatnonzero(alive)
    if live_ix.size == 0:
        return finish()

    # ---- stage 4: fixed-N+M min-cost re-fit of F at the achieved goal
    F_all, _, ok4 = grouped_pinned(
        achieved[live_ix], n_int[live_ix], M_int[live_ix], "cost"
    )
    for row, i in enumerate(live_ix):
        if not ok4[row]:
            alive[i] = False
            continue
        F = F_all[row]
        obj = float(
            (F * top.price_egress).sum() / GBIT_PER_GB
            + n_int[i] @ top.price_vm
        )
        results[i] = MILPResult(
            F=F,
            N=n_int[i].astype(np.int64),
            M=M_int[i].astype(np.int64),
            objective=obj,
            status="optimal",
            lp_objective=float(root_fun[i]),
            achieved_tput=float(achieved[i]),
        )
    return finish()
