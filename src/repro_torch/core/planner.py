"""Skyplane's planner (paper §4-§5): cost-min and throughput-max modes.

  * ``plan_cost_min``  — minimize $ subject to a throughput floor (Eq. 4a-4j).
  * ``plan_tput_max``  — maximize throughput subject to a price ceiling, via
    the paper's §5.2 procedure: sweep cost-min solves over a range of
    throughput goals, form the Pareto frontier, pick the fastest plan whose
    cost fits the ceiling.

Planning runs on a pruned candidate subgraph (src, dst + top-K relays) —
mirroring how the open-source Skyplane keeps MILPs "solvable in under 5
seconds" — and maps the solution back onto the full topology.

Solver backends (the planner hot path):

  * ``backend="numpy"`` (default) — the sequential reference pipeline; each
    LP re-derives from the cached ``milp.LPStructure`` and solves on the
    dense numpy IPM.
  * ``backend="torch"`` — the same round-down pipeline, but every stage of
    the sweep (root relaxations, feasibility-repair probes, fixed-N and
    fixed-N+M refits) runs as one batched torch IPM call across all samples
    on the planner's ``device`` (None = the card), with per-sample numpy
    fallback on KKT failure. This is the *integerized*
    fast path; ``pareto_frontier_fast`` remains the continuous-relaxation
    shortcut for frontier exploration.

Pruned subgraphs (and the LP structures cached on them) are memoized per
(src, dst), so repeated planner calls — the "thousands of solves" workload
of systems built on this planner — never re-assemble constraint matrices.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from repro_torch.obs.trace import get_tracer

from . import milp
from .plan import MulticastPlan, TransferPlan
from .solver.bnb import (
    _mc_scale_probe,
    solve_milp,
    solve_milp_batched,
    solve_multicast,
)
from .solver.ipm import solve_lp
from .spec import PlanSpec
from .topology import Topology


def _warn_deprecated(name: str) -> None:
    warnings.warn(
        f"Planner.{name}() is deprecated; build a core.PlanSpec and call "
        "Planner.plan(spec) (see README 'Planning API')",
        DeprecationWarning,
        stacklevel=3,
    )


@dataclasses.dataclass
class ParetoPoint:
    tput_goal: float
    cost_per_gb: float
    plan: TransferPlan


class Planner:
    def __init__(
        self,
        top: Topology,
        *,
        max_relays: int = 10,
        mode: str = "relaxed",  # "relaxed" (round-down, §5.1.3) or "exact"
        belief=None,  # calibrate.BeliefGrid powering the robustness knob
        link_capacity_scale: float | None = None,  # data-plane shared-link
        # capacity factor: robust scale cuts then also cap each drifted
        # link's AGGREGATE flow (incidents hit the interconnect, which more
        # VMs/connections cannot buy back)
        device=None,  # torch device of backend="torch" (None = the card)
    ):
        self.top = top
        self.device = device
        self.max_relays = max_relays
        self.mode = mode
        self.belief = belief
        self.link_capacity_scale = link_capacity_scale
        self._prune_cache: dict[tuple[str, str], tuple] = {}

    # ------------------------------------------------------------- robustness
    def _resolve_scale(
        self, robustness: float, tput_scale: np.ndarray | None
    ) -> np.ndarray | None:
        """The full-grid [V,V] throughput scale a solve should plan under.

        ``robustness`` > 0 asks the attached belief for its z-lower-
        confidence-bound grid relative to this planner's (epoch) grid;
        an explicit ``tput_scale`` composes with it elementwise (min —
        both pessimisms must hold). Returns None when nothing applies."""
        scale = None
        if robustness and robustness > 0.0:
            if self.belief is None:
                raise ValueError(
                    "robustness > 0 needs a belief attached to the Planner"
                )
            scale = self.belief.scale_grid(self.top, z=float(robustness))
        if tput_scale is not None:
            ts = np.asarray(tput_scale, dtype=float)
            scale = ts if scale is None else np.minimum(scale, ts)
        return scale

    def _scale_cuts(self, struct, keep, tput_scale, agg_scale=None) -> list:
        """Map a full-grid scale vector into ``struct``'s edge space and
        emit the tightened rows (``milp.*.scale_cuts``) — shared by the
        unicast and multicast paths, zero re-assembly either way.

        ``agg_scale`` (full-grid [V,V], non-finite = uncapped) adds
        per-link aggregate share caps — the fleet controller's weighted
        fair shares — composed with the data plane's scalar
        ``link_capacity_scale`` where both apply."""
        if tput_scale is None and agg_scale is None:
            return []
        ix = np.asarray(keep, dtype=np.int64)
        if tput_scale is not None:
            sub_scale = np.asarray(tput_scale, dtype=float)[np.ix_(ix, ix)]
            edge_scale = sub_scale[struct.eu, struct.ew]
        else:
            edge_scale = np.ones(struct.n_edges)
        agg = self.link_capacity_scale
        if agg_scale is not None:
            share = np.asarray(agg_scale, dtype=float)[np.ix_(ix, ix)]
            share_e = share[struct.eu, struct.ew]
            capped = np.isfinite(share_e)
            per_edge = np.where(capped, share_e, np.inf)
            if agg is not None:
                # a tenant's share of the data-plane capacity factor; on
                # drifted edges the plain incident cap must still hold
                per_edge = np.where(capped, share_e * float(agg), np.inf)
                drifted = edge_scale < 1.0 - 1e-9
                per_edge[drifted] = np.minimum(per_edge[drifted], float(agg))
            agg = per_edge
        return struct.scale_cuts(edge_scale, agg_cap=agg)

    # ----------------------------------------------------------------- bounds
    def _max_throughput(
        self,
        src: str,
        dst: str,
        *,
        degraded_links: dict[tuple[int, int], float] | None = None,
        vm_caps: dict[int, float] | None = None,
        robustness: float = 0.0,
        tput_scale: np.ndarray | None = None,
        agg_scale: np.ndarray | None = None,
    ) -> float:
        """Max achievable tput (Gbit/s): LP max-flow with N at the VM limit.

        degraded_links / vm_caps (full-topology region indices) constrain
        the same cached LPStructure — see the cost_min objective.
        robustness / tput_scale bound the flow by the scaled (lower-
        confidence) grid; agg_scale adds per-link share caps."""
        sub, s, t, keep = self._prune(src, dst)
        struct = milp.structure(sub, s, t)
        cuts = self._degrade_cuts(struct, keep, degraded_links, vm_caps)
        cuts = cuts + self._scale_cuts(
            struct, keep, self._resolve_scale(robustness, tput_scale),
            agg_scale,
        )
        fixed_n = np.full(sub.num_regions, float(sub.limit_vm))
        if vm_caps:
            inv = {full: i for i, full in enumerate(keep)}
            for r, cap in vm_caps.items():
                if r in inv:
                    fixed_n[inv[r]] = min(fixed_n[inv[r]], float(cap))
        lp = struct.lp(0.0, fixed_n=fixed_n, extra_ub=cuts or None)
        if lp.trivially_infeasible:
            return 0.0
        # maximize source egress == minimize -sum F_{s,*}
        c = struct.outflow_c(struct.pin_pattern(True, False))
        res = solve_lp(c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq)
        if not res.ok:
            return 0.0
        return float(-res.fun)

    def direct_throughput(
        self, src: str, dst: str, num_vms: int | None = None
    ) -> float:
        """Throughput of the direct path with ``num_vms`` VMs at each end."""
        n = float(num_vms if num_vms is not None else self.top.limit_vm)
        s, t = self.top.index(src), self.top.index(dst)
        return float(
            n * min(
                self.top.tput[s, t],
                self.top.limit_egress[s],
                self.top.limit_ingress[t],
            )
        )

    # --------------------------------------------------------------- unicast
    def _cost_min(
        self,
        src: str,
        dst: str,
        tput_goal_gbps: float,
        volume_gb: float,
        *,
        mode: str | None = None,
        backend: str = "numpy",
        degraded_links: dict[tuple[int, int], float] | None = None,
        vm_caps: dict[int, float] | None = None,
        robustness: float = 0.0,
        tput_scale: np.ndarray | None = None,
        agg_scale: np.ndarray | None = None,
    ) -> TransferPlan:
        """Paper mode 1: minimize cost subject to a throughput floor.

        degraded_links maps a full-topology (src_region, dst_region) index
        pair to the fraction of grid capacity the link still has; each
        becomes a tightened 4b row (F_e <= phi * tput_e / limit_conn * M_e)
        on the *cached* LPStructure. vm_caps maps a region index to a VM
        ceiling below the service limit (an unhealthy region; 0 excludes
        it). This is the degraded-topology re-planning hook of the
        fault-tolerant TransferService: nothing is re-assembled, the cuts
        ride on the memoized structure as extra rows.

        robustness > 0 plans against the attached belief's z-lower-
        confidence-bound grid (uncertainty-aware planning); tput_scale
        applies an explicit full-grid scale. Both ride the cached
        structure as scale cuts — the same zero-reassembly discipline.
        """
        sub, s, t, keep = self._prune(src, dst)
        scale = self._resolve_scale(robustness, tput_scale)
        cuts = None
        if degraded_links or vm_caps or scale is not None or agg_scale is not None:
            struct = milp.structure(sub, s, t)
            cuts = self._degrade_cuts(struct, keep, degraded_links, vm_caps)
            cuts = cuts + self._scale_cuts(struct, keep, scale, agg_scale)
        res = solve_milp(sub, s, t, tput_goal_gbps, mode=mode or self.mode,
                         backend=backend, extra_ub=cuts or None,
                         device=self.device)
        return self._lift(sub, keep, src, dst, tput_goal_gbps, volume_gb, res)

    def _tput_max(
        self,
        src: str,
        dst: str,
        cost_ceiling_per_gb: float,
        volume_gb: float,
        *,
        n_samples: int = 40,
        mode: str | None = None,
        backend: str = "numpy",
        robustness: float = 0.0,
        tput_scale: np.ndarray | None = None,
    ) -> TransferPlan:
        """Paper mode 2 (§5.2): Pareto sweep, pick fastest plan under ceiling."""
        frontier = self._pareto(
            src, dst, volume_gb, n_samples=n_samples, mode=mode,
            backend=backend, robustness=robustness, tput_scale=tput_scale,
        )
        feasible = [p for p in frontier if p.cost_per_gb <= cost_ceiling_per_gb + 1e-9]
        if not feasible:
            # ceiling below even the cheapest plan: return cheapest as "best effort"
            cheapest = min(frontier, key=lambda p: p.cost_per_gb)
            plan = cheapest.plan
            plan.solver_status = "cost_ceiling_infeasible"
            return plan
        best = max(feasible, key=lambda p: p.tput_goal)
        return best.plan

    # -------------------------------------------------------------- multicast
    def _mc_cost_min(
        self,
        src: str,
        dsts: list[str],
        tput_floor_gbps,
        volume_gb: float,
        *,
        degraded_links: dict[tuple[int, int], float] | None = None,
        vm_caps: dict[int, float] | None = None,
        robustness: float = 0.0,
        tput_scale: np.ndarray | None = None,
        agg_scale: np.ndarray | None = None,
    ) -> MulticastPlan:
        """One-to-many cost-min: minimize $ with every destination receiving
        at least its throughput floor, billing each overlay link's egress
        once for the shared chunk stream (core/milp.MulticastLPStructure).

        ``tput_floor_gbps`` is a scalar floor applied to every destination
        or a per-destination sequence (zeros drop a destination from the
        trees — how the service re-plans only the surviving branches of a
        partially completed replication). degraded_links / vm_caps take
        full-topology indices and become extra rows on the cached structure,
        exactly as in ``plan_cost_min`` — re-planning re-assembles nothing.

        A single destination delegates to the unicast round-down, so the
        plan is bit-for-bit the one ``plan_cost_min`` returns.
        """
        goals = np.asarray(tput_floor_gbps, dtype=float)
        if goals.ndim == 0:
            goals = np.full(len(dsts), float(goals))
        if goals.shape != (len(dsts),):
            raise ValueError("need one throughput floor per destination")
        if len(dsts) == 1:
            uni = self._cost_min(
                src, dsts[0], float(goals[0]), volume_gb,
                degraded_links=degraded_links, vm_caps=vm_caps,
                robustness=robustness, tput_scale=tput_scale,
                agg_scale=agg_scale,
            )
            return MulticastPlan(
                top=self.top, src=uni.src, dsts=[uni.dst],
                tput_goals=goals, volume_gb=volume_gb,
                G=uni.F.copy(), F=uni.F[None, :, :].copy(),
                N=uni.N, M=uni.M, solver_status=uni.solver_status,
            )
        sub, s, ds, keep = self._prune_mc(src, dsts)
        scale = self._resolve_scale(robustness, tput_scale)
        cuts = None
        if degraded_links or vm_caps or scale is not None or agg_scale is not None:
            struct = milp.multicast_structure(sub, s, ds)
            cuts = self._mc_degrade_cuts(struct, keep, degraded_links, vm_caps)
            cuts = cuts + self._scale_cuts(struct, keep, scale, agg_scale)
        res = solve_multicast(sub, s, ds, goals, extra_ub=cuts or None)
        return self._lift_mc(sub, keep, src, dsts, goals, volume_gb, res)

    def _mc_tput_max(
        self,
        src: str,
        dsts: list[str],
        cost_ceiling_per_gb: float,
        volume_gb: float,
        *,
        n_samples: int = 12,
        robustness: float = 0.0,
        tput_scale: np.ndarray | None = None,
    ) -> MulticastPlan:
        """One-to-many throughput-max under a cost ceiling (§5.2 applied to
        the multicast MILP): sweep uniform per-destination floors, estimate
        the cost frontier from ONE batched relaxation solve (the sweep LPs
        share every matrix of the cached structure and differ only in the
        goal rows of b), then integerize candidates fastest-first until one
        fits the ceiling. robustness / tput_scale constrain the candidate
        range and every integerized solve by the scaled grid (the batched
        relaxation filter itself stays cut-free; over-optimistic candidates
        are rejected by the exact robust re-check)."""
        if len(dsts) == 1:
            uni = self._tput_max(src, dsts[0], cost_ceiling_per_gb,
                                 volume_gb, robustness=robustness,
                                 tput_scale=tput_scale)
            return MulticastPlan(
                top=self.top, src=uni.src, dsts=[uni.dst],
                tput_goals=np.array([uni.tput_goal]), volume_gb=volume_gb,
                G=uni.F.copy(), F=uni.F[None, :, :].copy(),
                N=uni.N, M=uni.M, solver_status=uni.solver_status,
            )
        from .solver.ipm_batch import solve_lp_batched_auto

        sub, s, ds, keep = self._prune_mc(src, dsts)
        hi = self._mc_max_throughput(
            src, dsts, robustness=robustness, tput_scale=tput_scale
        )
        if hi <= 0:
            raise ValueError(f"no multicast path from {src} to {dsts}")
        rates = np.linspace(hi / n_samples, hi * 0.999, n_samples)
        struct = milp.multicast_structure(sub, s, ds)
        lp = struct.lp(np.full(len(ds), float(rates[0])))
        b_batch = np.tile(lp.b_ub[None, :], (n_samples, 1))
        for i, g in enumerate(rates):
            b_batch[i, struct.rows_4c] = -g
            b_batch[i, struct.rows_4d] = -g
        _, _funs, ok = solve_lp_batched_auto(
            lp.c, lp.A_ub, b_batch, lp.A_eq, lp.b_eq
        )
        # the batched relaxation sweep prunes infeasible rates; exact
        # integerized costs are re-checked below, fastest-first
        cand = sorted(
            (float(g) for i, g in enumerate(rates) if ok[i]),
            reverse=True,
        )
        best: MulticastPlan | None = None
        for g in cand:
            plan = self._mc_cost_min(
                src, dsts, g, volume_gb,
                robustness=robustness, tput_scale=tput_scale,
            )
            if plan.solver_status != "optimal":
                continue
            if best is None or plan.cost_per_gb < best.cost_per_gb:
                best = plan
            if plan.cost_per_gb <= cost_ceiling_per_gb + 1e-9:
                return plan
        if best is None:
            raise RuntimeError(f"no feasible multicast plan {src}->{dsts}")
        best.solver_status = "cost_ceiling_infeasible"
        return best

    def _mc_max_throughput(
        self,
        src: str,
        dsts: list[str],
        *,
        degraded_links: dict[tuple[int, int], float] | None = None,
        vm_caps: dict[int, float] | None = None,
        robustness: float = 0.0,
        tput_scale: np.ndarray | None = None,
        agg_scale: np.ndarray | None = None,
    ) -> float:
        """Max uniform per-destination rate (Gbit/s) with N at the VM limit
        — the multicast scale probe with unit goals and no cap."""
        sub, s, ds, keep = self._prune_mc(src, dsts)
        struct = milp.multicast_structure(sub, s, ds)
        cuts = self._mc_degrade_cuts(struct, keep, degraded_links, vm_caps)
        cuts = cuts + self._scale_cuts(
            struct, keep, self._resolve_scale(robustness, tput_scale),
            agg_scale,
        )
        fixed_n = np.full(sub.num_regions, float(sub.limit_vm))
        if vm_caps:
            inv = {full: i for i, full in enumerate(keep)}
            for r, cap in vm_caps.items():
                if r in inv:
                    fixed_n[inv[r]] = min(fixed_n[inv[r]], float(cap))
        return _mc_scale_probe(
            struct, np.ones(len(ds)), fixed_n=fixed_n,
            extra_ub=cuts or None, cap=None,
        )

    def _pareto_fast(
        self,
        src: str,
        dst: str,
        volume_gb: float,
        *,
        n_samples: int = 64,
    ) -> list[ParetoPoint]:
        """§5.2 sweep as ONE batched IPM solve (solver/ipm_batch).

        The N cost-min LPs differ only in the two goal rows of b, so the
        relaxation solves as a single vmapped call; plans returned here are
        the *continuous* relaxations (≤1% from integral per §5.1.3 — used
        for frontier exploration). ``pareto_frontier(backend="torch")`` is the
        batched *integerized* sweep; ``plan_tput_max`` integerizes winners."""
        from .solver.ipm_batch import solve_lp_batched_auto as solve_lp_batched

        sub, s, t, keep = self._prune(src, dst)
        hi = self._max_throughput(src, dst)
        if hi <= 0:
            raise ValueError(f"no path from {src} to {dst}")
        goals = np.linspace(hi / n_samples, hi * 0.999, n_samples)
        lp = milp.structure(sub, s, t).lp(float(goals[0]))
        b_batch = np.tile(lp.b_ub[None, :], (n_samples, 1))
        b_batch[:, lp.row_4c] = -goals
        b_batch[:, lp.row_4d] = -goals
        xs, funs, ok = solve_lp_batched(lp.c, lp.A_ub, b_batch, lp.A_eq, lp.b_eq)
        out = []
        for i, g in enumerate(goals):
            if not ok[i]:
                continue
            F, N, M = lp.split(xs[i])
            res = type("R", (), {})()
            res.F, res.N, res.M = F, N, M
            res.status = "optimal"
            res.achieved_tput = float(g)
            plan = self._lift(sub, keep, src, dst, float(g), volume_gb, res)
            out.append(ParetoPoint(float(g), plan.cost_per_gb, plan))
        if not out:
            # numerical fallback: the exact sequential path
            return self._pareto(src, dst, volume_gb,
                                n_samples=min(n_samples, 20))
        return out

    def _pareto(
        self,
        src: str,
        dst: str,
        volume_gb: float,
        *,
        n_samples: int = 40,
        mode: str | None = None,
        backend: str = "numpy",
        robustness: float = 0.0,
        tput_scale: np.ndarray | None = None,
    ) -> list[ParetoPoint]:
        """Cost-min solves across a range of throughput goals (paper §5.2).

        backend="torch" runs the whole integerized sweep stage-by-stage through
        the batched torch IPM (solve_milp_batched) instead of n_samples
        sequential round-downs; results match the numpy path (per-sample
        fallback covers KKT failures). The exact B&B mode is sequential-only,
        as are robust sweeps (scale cuts are per-instance extra rows the
        shared-matrix batched pipeline does not take).
        """
        if backend not in ("numpy", "torch"):
            raise ValueError(f"unknown backend {backend!r} (use numpy or torch)")
        sub, s, t, keep = self._prune(src, dst)
        scale = self._resolve_scale(robustness, tput_scale)
        cuts = None
        if scale is not None:
            struct = milp.structure(sub, s, t)
            cuts = self._scale_cuts(struct, keep, scale) or None
        hi = self._max_throughput(src, dst, tput_scale=scale)
        if hi <= 0:
            raise ValueError(f"no path from {src} to {dst}")
        goals = np.linspace(hi / n_samples, hi * 0.999, n_samples)
        out = []
        if backend == "torch" and (mode or self.mode) == "relaxed" and not cuts:
            batch = solve_milp_batched(
                sub, s, t, goals, engine="torch", device=self.device
            )
            for g, res in zip(goals, batch):
                if not res.ok:
                    continue
                plan = self._lift(sub, keep, src, dst, float(g), volume_gb, res)
                out.append(ParetoPoint(float(g), plan.cost_per_gb, plan))
        else:
            for g in goals:
                res = solve_milp(sub, s, t, float(g), mode=mode or self.mode,
                                 extra_ub=cuts)
                if not res.ok:
                    continue
                plan = self._lift(sub, keep, src, dst, float(g), volume_gb, res)
                out.append(ParetoPoint(float(g), plan.cost_per_gb, plan))
        if not out:
            raise RuntimeError(f"planner found no feasible plan {src}->{dst}")
        return out

    # ------------------------------------------------------------- public API
    def plan(self, spec: PlanSpec):
        """THE planning entry point: one ``PlanSpec`` in, one result out.

        Dispatches on ``spec.objective`` (and ``dst`` vs ``dsts`` for the
        unicast/multicast formulation). Returns a ``TransferPlan`` /
        ``MulticastPlan`` for ``cost_min`` and ``tput_max``, a float for
        ``max_throughput``, and a list of ``ParetoPoint`` for the sweeps.
        The eight legacy ``plan_*`` / ``max_*`` / ``pareto_*`` methods are
        deprecated shims over this method."""
        tr = get_tracer()
        if not tr.enabled:
            return self._plan_impl(spec)
        w0 = tr.now_wall()
        b0 = milp._struct_builds.value
        result = self._plan_impl(spec)
        tr.span(
            "planner.plan", w0, tr.now_wall() - w0, track="planner",
            objective=spec.objective, src=spec.src,
            dst=spec.dst if not spec.multicast else ",".join(spec.dsts),
            struct_builds=int(milp._struct_builds.value - b0),
        )
        return result

    def _plan_impl(self, spec: PlanSpec):
        obj = spec.objective
        ns = {} if spec.n_samples is None else {"n_samples": spec.n_samples}
        if obj == "cost_min":
            if spec.multicast:
                return self._mc_cost_min(
                    spec.src, list(spec.dsts), spec.goals(), spec.volume_gb,
                    degraded_links=spec.degraded_links_map,
                    vm_caps=spec.vm_caps_map, robustness=spec.robustness,
                    tput_scale=spec.tput_scale, agg_scale=spec.agg_scale,
                )
            return self._cost_min(
                spec.src, spec.dst, spec.goals(), spec.volume_gb,
                mode=spec.mode, backend=spec.backend,
                degraded_links=spec.degraded_links_map,
                vm_caps=spec.vm_caps_map, robustness=spec.robustness,
                tput_scale=spec.tput_scale, agg_scale=spec.agg_scale,
            )
        if obj == "tput_max":
            if spec.multicast:
                return self._mc_tput_max(
                    spec.src, list(spec.dsts), spec.cost_ceiling_per_gb,
                    spec.volume_gb, robustness=spec.robustness,
                    tput_scale=spec.tput_scale, **ns,
                )
            return self._tput_max(
                spec.src, spec.dst, spec.cost_ceiling_per_gb, spec.volume_gb,
                mode=spec.mode, backend=spec.backend,
                robustness=spec.robustness, tput_scale=spec.tput_scale, **ns,
            )
        if obj == "max_throughput":
            if spec.multicast:
                return self._mc_max_throughput(
                    spec.src, list(spec.dsts),
                    degraded_links=spec.degraded_links_map,
                    vm_caps=spec.vm_caps_map, robustness=spec.robustness,
                    tput_scale=spec.tput_scale, agg_scale=spec.agg_scale,
                )
            return self._max_throughput(
                spec.src, spec.dst,
                degraded_links=spec.degraded_links_map,
                vm_caps=spec.vm_caps_map, robustness=spec.robustness,
                tput_scale=spec.tput_scale, agg_scale=spec.agg_scale,
            )
        if obj == "pareto":
            return self._pareto(
                spec.src, spec.dst, spec.volume_gb, mode=spec.mode,
                backend=spec.backend, robustness=spec.robustness,
                tput_scale=spec.tput_scale, **ns,
            )
        return self._pareto_fast(spec.src, spec.dst, spec.volume_gb, **ns)

    def plan_cohort(self, specs: list[PlanSpec]) -> list:
        """Plan a whole admitted cohort in one sweep.

        Unicast ``cost_min`` specs in relaxed mode carrying no per-spec
        cuts are grouped by (src, dst) route and each group solves as ONE
        batched round-down sweep (``solve_milp_batched``) over the route's
        cached LPStructure — the fleet controller's admission path, a
        single stacked solve instead of a Python loop of per-job planner
        calls. Everything else (multicast, robust, degraded, exact-mode)
        falls back to the sequential ``plan()`` path, which still rides
        cached structures. Results come back in spec order. Each group
        solves on its specs' ``backend`` engine ("torch" on the planner's
        device, else numpy)."""
        tr = get_tracer()
        w0 = tr.now_wall() if tr.enabled else 0.0
        out: list = [None] * len(specs)
        groups: dict[tuple[str, str], list[int]] = {}
        for i, sp in enumerate(specs):
            batchable = (
                sp.objective == "cost_min"
                and not sp.multicast
                and (sp.mode or self.mode) == "relaxed"
                and not sp.degraded_links
                and not sp.vm_caps
                and not sp.robustness
                and sp.tput_scale is None
                and sp.agg_scale is None
            )
            if batchable:
                groups.setdefault((sp.src, sp.dst, sp.backend), []).append(i)
            else:
                out[i] = self.plan(sp)
        for (src, dst, backend), ix in groups.items():
            sub, s, t, keep = self._prune(src, dst)
            goals = np.array([specs[i].goals() for i in ix], dtype=float)
            engine = "torch" if backend == "torch" else "numpy"
            batch = solve_milp_batched(
                sub, s, t, goals, engine=engine, device=self.device
            )
            for i, g, res in zip(ix, goals, batch):
                if not res.ok:
                    # infeasible-goal corner: re-solve sequentially so the
                    # caller sees the same degraded status plan() returns
                    out[i] = self.plan(specs[i])
                    continue
                out[i] = self._lift(
                    sub, keep, src, dst, float(g), specs[i].volume_gb, res
                )
        if tr.enabled:
            tr.span(
                "planner.plan_cohort", w0, tr.now_wall() - w0,
                track="planner", n_specs=len(specs),
                n_batched_routes=len(groups),
            )
        return out

    # ------------------------------------------------- deprecated shims
    # The pre-PlanSpec surface: each method warns, builds the equivalent
    # spec, and delegates to plan() — bitwise-identical results (pinned
    # by tests/test_api_surface.py).
    def max_throughput(self, src, dst, *, degraded_links=None, vm_caps=None,
                       robustness=0.0, tput_scale=None):
        _warn_deprecated("max_throughput")
        return self.plan(PlanSpec(
            objective="max_throughput", src=src, dst=dst,
            degraded_links=degraded_links, vm_caps=vm_caps,
            robustness=robustness, tput_scale=tput_scale,
        ))

    def max_multicast_throughput(self, src, dsts, *, degraded_links=None,
                                 vm_caps=None, robustness=0.0,
                                 tput_scale=None):
        _warn_deprecated("max_multicast_throughput")
        return self.plan(PlanSpec(
            objective="max_throughput", src=src, dsts=tuple(dsts),
            degraded_links=degraded_links, vm_caps=vm_caps,
            robustness=robustness, tput_scale=tput_scale,
        ))

    def plan_cost_min(self, src, dst, tput_goal_gbps, volume_gb, *,
                      mode=None, backend="numpy", degraded_links=None,
                      vm_caps=None, robustness=0.0, tput_scale=None):
        _warn_deprecated("plan_cost_min")
        return self.plan(PlanSpec(
            objective="cost_min", src=src, dst=dst,
            tput_goal_gbps=tput_goal_gbps, volume_gb=volume_gb, mode=mode,
            backend=backend, degraded_links=degraded_links, vm_caps=vm_caps,
            robustness=robustness, tput_scale=tput_scale,
        ))

    def plan_tput_max(self, src, dst, cost_ceiling_per_gb, volume_gb, *,
                      n_samples=40, mode=None, backend="numpy",
                      robustness=0.0, tput_scale=None):
        _warn_deprecated("plan_tput_max")
        return self.plan(PlanSpec(
            objective="tput_max", src=src, dst=dst,
            cost_ceiling_per_gb=cost_ceiling_per_gb, volume_gb=volume_gb,
            n_samples=n_samples, mode=mode, backend=backend,
            robustness=robustness, tput_scale=tput_scale,
        ))

    def plan_multicast_cost_min(self, src, dsts, tput_floor_gbps, volume_gb,
                                *, degraded_links=None, vm_caps=None,
                                robustness=0.0, tput_scale=None):
        _warn_deprecated("plan_multicast_cost_min")
        return self.plan(PlanSpec(
            objective="cost_min", src=src, dsts=tuple(dsts),
            tput_goal_gbps=tput_floor_gbps, volume_gb=volume_gb,
            degraded_links=degraded_links, vm_caps=vm_caps,
            robustness=robustness, tput_scale=tput_scale,
        ))

    def plan_multicast_tput_max(self, src, dsts, cost_ceiling_per_gb,
                                volume_gb, *, n_samples=12, robustness=0.0,
                                tput_scale=None):
        _warn_deprecated("plan_multicast_tput_max")
        return self.plan(PlanSpec(
            objective="tput_max", src=src, dsts=tuple(dsts),
            cost_ceiling_per_gb=cost_ceiling_per_gb, volume_gb=volume_gb,
            n_samples=n_samples, robustness=robustness,
            tput_scale=tput_scale,
        ))

    def pareto_frontier(self, src, dst, volume_gb, *, n_samples=40,
                        mode=None, backend="numpy", robustness=0.0,
                        tput_scale=None):
        _warn_deprecated("pareto_frontier")
        return self.plan(PlanSpec(
            objective="pareto", src=src, dst=dst, volume_gb=volume_gb,
            n_samples=n_samples, mode=mode, backend=backend,
            robustness=robustness, tput_scale=tput_scale,
        ))

    def pareto_frontier_fast(self, src, dst, volume_gb, *, n_samples=64):
        _warn_deprecated("pareto_frontier_fast")
        return self.plan(PlanSpec(
            objective="pareto_fast", src=src, dst=dst, volume_gb=volume_gb,
            n_samples=n_samples,
        ))

    # -------------------------------------------------------------- internals
    @staticmethod
    def _degrade_cuts(
        struct,
        keep: list[int],
        degraded_links: dict[tuple[int, int], float] | None,
        vm_caps: dict[int, float] | None,
    ) -> list[tuple[np.ndarray, float]]:
        """Degraded-topology constraints as extra_ub rows of ``struct``.

        Indices in the input dicts are full-topology; they are mapped into
        the pruned structure's space (entries whose regions were pruned away
        are irrelevant and dropped). Returns [] when nothing applies."""
        inv = {full: i for i, full in enumerate(keep)}
        e, v = struct.n_edges, struct.num_regions
        edge_ix = {edge: k for k, edge in enumerate(struct.edges)}
        cuts: list[tuple[np.ndarray, float]] = []
        for (a, b), phi in (degraded_links or {}).items():
            sa, sb = inv.get(a), inv.get(b)
            if sa is None or sb is None or (sa, sb) not in edge_ix:
                continue
            k = edge_ix[(sa, sb)]
            row = np.zeros(struct.nx)
            row[k] = 1.0  # F_e <= phi * tput_e / limit_conn * M_e
            row[e + v + k] = (
                -float(phi) * struct.top.tput[sa, sb] / struct.top.limit_conn
            )
            cuts.append((row, 0.0))
        for r, cap in (vm_caps or {}).items():
            sr = inv.get(r)
            if sr is None or float(cap) >= struct.top.limit_vm:
                continue
            row = np.zeros(struct.nx)
            row[e + sr] = 1.0  # N_r <= cap (unhealthy region)
            cuts.append((row, float(cap)))
        return cuts

    @staticmethod
    def _mc_degrade_cuts(
        struct,
        keep: list[int],
        degraded_links: dict[tuple[int, int], float] | None,
        vm_caps: dict[int, float] | None,
    ) -> list[tuple[np.ndarray, float]]:
        """Degraded-topology rows in the multicast variable space: the
        tightened 4b row binds the *envelope* (what actually crosses the
        link), and VM caps bind N — all as extra_ub on the cached
        structure, nothing re-assembled."""
        inv = {full: i for i, full in enumerate(keep)}
        edge_ix = {edge: k for k, edge in enumerate(struct.edges)}
        cuts: list[tuple[np.ndarray, float]] = []
        for (a, b), phi in (degraded_links or {}).items():
            sa, sb = inv.get(a), inv.get(b)
            if sa is None or sb is None or (sa, sb) not in edge_ix:
                continue
            k = edge_ix[(sa, sb)]
            row = np.zeros(struct.nx)
            row[k] = 1.0  # G_e <= phi * tput_e / limit_conn * M_e
            row[struct.iM + k] = (
                -float(phi) * struct.top.tput[sa, sb] / struct.top.limit_conn
            )
            cuts.append((row, 0.0))
        for r, cap in (vm_caps or {}).items():
            sr = inv.get(r)
            if sr is None or float(cap) >= struct.top.limit_vm:
                continue
            row = np.zeros(struct.nx)
            row[struct.iN + sr] = 1.0
            cuts.append((row, float(cap)))
        return cuts

    def _prune_mc(self, src: str, dsts: list[str]):
        """Pruned candidate subgraph for one-to-many planning: source, all
        destinations, and the ``max_relays`` regions with the best two-hop
        bottleneck score toward ANY destination. Memoized per (src, dsts)
        so the multicast LP structure cached on it survives re-planning."""
        key = (src, tuple(dsts))
        hit = self._prune_cache.get(key)
        if hit is not None:
            return hit
        s_full = self.top.index(src)
        d_full = [self.top.index(d) for d in dsts]
        v = self.top.num_regions
        if v <= self.max_relays + 1 + len(dsts):
            keep = list(range(v))
        else:
            score = np.full(v, -np.inf)
            for d in d_full:
                score = np.maximum(
                    score, np.minimum(self.top.tput[s_full, :],
                                      self.top.tput[:, d])
                )
            score[[s_full, *d_full]] = -np.inf
            order = np.argsort(-score)
            relays = [int(i) for i in order[: self.max_relays]
                      if np.isfinite(score[i])]
            keep = sorted({s_full, *d_full, *relays})
        sub = self.top.subgraph(keep)
        s = keep.index(s_full)
        ds = tuple(keep.index(d) for d in d_full)
        out = (sub, s, ds, keep)
        self._prune_cache[key] = out
        return out

    def _lift_mc(
        self, sub, keep, src, dsts, goals, volume_gb, res
    ) -> MulticastPlan:
        v = self.top.num_regions
        D = len(dsts)
        ix = np.asarray(keep)
        G = np.zeros((v, v))
        F = np.zeros((D, v, v))
        M = np.zeros((v, v))
        N = np.zeros(v)
        G[np.ix_(ix, ix)] = res.G
        F[np.ix_(np.arange(D), ix, ix)] = res.F
        M[np.ix_(ix, ix)] = res.M
        N[ix] = res.N
        achieved = getattr(res, "achieved_goals", None)
        tgt = (np.minimum(goals, achieved) if achieved is not None
               else np.asarray(goals, dtype=float))
        return MulticastPlan(
            top=self.top,
            src=self.top.index(src),
            dsts=[self.top.index(d) for d in dsts],
            tput_goals=tgt,
            volume_gb=volume_gb,
            G=G,
            F=F,
            N=N,
            M=M,
            solver_status=res.status,
        )

    def _prune(self, src: str, dst: str):
        """Pruned candidate subgraph for (src, dst), memoized so the LP
        structures cached on the subgraph survive across planner calls."""
        key = (src, dst)
        hit = self._prune_cache.get(key)
        if hit is not None:
            return hit
        s_full, t_full = self.top.index(src), self.top.index(dst)
        v = self.top.num_regions
        if v <= self.max_relays + 2:
            keep = list(range(v))
            out = (self.top, s_full, t_full, keep)
        else:
            sub, s, t = self.top.candidate_subgraph(src, dst, self.max_relays)
            # recover kept indices in full-topology space
            keep = [self.top.index(r.key) for r in sub.regions]
            out = (sub, s, t, keep)
        self._prune_cache[key] = out
        return out

    def _lift(
        self, sub, keep, src, dst, tput_goal, volume_gb, res
    ) -> TransferPlan:
        v = self.top.num_regions
        F = np.zeros((v, v))
        M = np.zeros((v, v))
        N = np.zeros(v)
        ix = np.asarray(keep)
        F[np.ix_(ix, ix)] = res.F
        M[np.ix_(ix, ix)] = res.M
        N[ix] = res.N
        achieved = getattr(res, "achieved_tput", 0.0) or tput_goal
        return TransferPlan(
            top=self.top,
            src=self.top.index(src),
            dst=self.top.index(dst),
            tput_goal=min(tput_goal, achieved),
            volume_gb=volume_gb,
            F=F,
            N=N,
            M=M,
            solver_status=res.status,
        )
