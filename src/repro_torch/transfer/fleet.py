"""Fleet control plane: multi-tenant transfer-as-a-service on ONE belief.

``FleetController`` runs many tenants' transfer jobs through a single
:class:`~repro_torch.calibrate.service.CalibratedTransferService` loop instead
of one service instance per tenant. What the fleet shares, and what it
isolates:

  * **One belief, one calibrator.** Every tenant's probes and passive
    telemetry fold into the same :class:`BeliefGrid`; the shared
    :class:`Calibrator` runs with a probe dedup window, so a link any
    tenant measured recently is skipped in the next tenant's broad VoI
    sweep — probe dollars amortize across the fleet instead of N
    services re-measuring the same grid. Readers that need a stable view
    take epoch-versioned ``BeliefGrid.snapshot()``s.

  * **Admission control.** Queued requests are admitted in waves against
    per-route capacity (``max_throughput`` on the CACHED structures):
    deadline-class jobs are admitted first at their requested goal;
    bulk jobs take what fits under ``admission_margin`` of the route's
    remaining capacity, and a bulk job that would be squeezed below
    ``min_admit_frac`` of its request is *deferred* — its arrival is
    pushed past the estimated drain time of the jobs ahead of it, so it
    plans at full goal for a later wave instead of trickling now.

  * **Weighted max-min link shares.** Contended links (where the summed
    admitted demand exceeds the shared-link capacity) get per-tenant
    fair shares: deadline demand is carved out first, bulk tenants
    water-fill the residual in proportion to their weights. The shares
    ride every RE-plan as per-link aggregate ``agg_scale`` cuts — extra
    rows on the cached LP structures, zero re-assembly — so one tenant's
    re-routed remainder cannot squeeze another tenant off a link the
    fleet already arbitrated.

  * **One batched cohort solve.** The admitted wave's unicast cost-min
    specs are planned by ``Planner.plan_cohort`` — grouped by route and
    solved as ONE stacked ``solve_milp_batched`` sweep, not a Python
    loop of per-job planner calls.

Execution, drift detection, deadline ladders, breakers and epoch rolls
are all inherited unchanged — the fleet is a policy layer over the
calibrated loop, not a new data plane.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.calibrate.calibrator import Calibrator
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import get_tracer
from repro_torch.calibrate.service import (
    CalibratedServiceReport,
    CalibratedTransferService,
)
from repro_torch.core.topology import GBIT_PER_GB

from .executor import TransferRequest, _JobState
from .reports import Report

__all__ = [
    "FleetController",
    "FleetReport",
    "TenantReport",
    "TenantSpec",
]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant of the fleet.

    ``weight`` scales the tenant's bulk share in the weighted max-min
    water-fill; ``slo_class`` is ``"bulk"`` or ``"deadline"`` (deadline
    tenants are admitted and allocated before any bulk tenant);
    ``vm_quota`` caps the total VMs any single plan of this tenant may
    provision (enforced by goal backoff at admission); re-plans may
    additionally borrow idle quota from tenants that have drained — the
    pooled-subscription dividend of running as a fleet."""

    name: str
    weight: float = 1.0
    slo_class: str = "bulk"
    vm_quota: float | None = None

    def __post_init__(self):
        if self.slo_class not in ("bulk", "deadline"):
            raise ValueError(
                f"slo_class must be 'bulk' or 'deadline', "
                f"got {self.slo_class!r}"
            )
        if self.weight <= 0:
            raise ValueError("tenant weight must be positive")


@dataclasses.dataclass
class TenantReport(Report):
    """Per-tenant rollup of the fleet run."""

    name: str
    weight: float
    slo_class: str
    jobs: int
    requested_gb: float
    delivered_gb: float
    realized_cost: float
    deferred: int  # jobs pushed to a later admission wave
    quota_clamps: int  # jobs goal-backed-off to fit the VM quota
    deadline_misses: int
    probe_cost_share_usd: float  # shared calibrator cost / n_tenants
    quota_borrows: int = 0  # re-plans that ran on borrowed idle VM quota

    kind = "tenant"
    _summary_keys = ("name", "slo_class", "jobs", "delivered_gb",
                     "deferred", "deadline_misses")

    def _payload(self) -> dict:
        return {
            "name": self.name,
            "weight": self.weight,
            "slo_class": self.slo_class,
            "jobs": self.jobs,
            "requested_gb": self.requested_gb,
            "delivered_gb": self.delivered_gb,
            "realized_cost": self.realized_cost,
            "deferred": self.deferred,
            "quota_clamps": self.quota_clamps,
            "deadline_misses": self.deadline_misses,
            "probe_cost_share_usd": self.probe_cost_share_usd,
            "quota_borrows": self.quota_borrows,
        }


@dataclasses.dataclass
class FleetReport(CalibratedServiceReport):
    """The calibrated-service report plus the per-tenant rollups."""

    tenants: list[TenantReport] = dataclasses.field(default_factory=list)
    deferred_jobs: int = 0

    kind = "fleet"
    _summary_keys = ("jobs", "tenants_n", "time_s", "delivered_gb",
                     "probe_cost_usd", "deferred_jobs")
    _metrics_prefixes = ("planner.", "service.", "breaker.", "calibrate.",
                         "fleet.")

    def _payload(self) -> dict:
        d = super()._payload()
        d.update({
            "tenants_n": len(self.tenants),
            "deferred_jobs": self.deferred_jobs,
            "tenants": [t.to_dict() for t in self.tenants],
        })
        return d


def weighted_max_min(
    weights: list[float], demands: list[float], capacity: float
) -> list[float]:
    """Weighted max-min fair allocation of ``capacity`` across demands.

    Classic water-fill: repeatedly offer each unsatisfied demand its
    weight-proportional share of the remaining capacity; demands smaller
    than their share are fully satisfied and leave, donating the excess
    to the next round."""
    alloc = [0.0] * len(demands)
    active = [i for i, d in enumerate(demands) if d > _EPS]
    remaining = float(capacity)
    while active and remaining > _EPS:
        wsum = sum(weights[i] for i in active)
        fair = {i: remaining * weights[i] / wsum for i in active}
        satisfied = [i for i in active if demands[i] - alloc[i]
                     <= fair[i] + _EPS]
        if not satisfied:
            for i in active:
                alloc[i] += fair[i]
            remaining = 0.0
            break
        for i in satisfied:
            take = demands[i] - alloc[i]
            alloc[i] = demands[i]
            remaining -= take
        active = [i for i in active if i not in satisfied]
    return alloc


class FleetController(CalibratedTransferService):
    """Multi-tenant transfer-as-a-service over one calibrated loop.

    Usage::

        fleet = FleetController(drift, tenants=[
            TenantSpec("analytics", weight=1.0),
            TenantSpec("ml-sync", weight=2.0, slo_class="deadline"),
        ])
        fleet.submit(TransferRequest(...), tenant="analytics")
        report = fleet.run()
    """

    def __init__(
        self,
        drift,
        *,
        tenants: list[TenantSpec],
        probe_dedup_window_s: float = 8.0,
        admission_margin: float = 0.9,
        min_admit_frac: float = 0.35,
        min_link_share: float = 0.05,
        headroom_boost: float = 1.5,
        **kw,
    ):
        if not tenants:
            raise ValueError("a fleet needs at least one TenantSpec")
        self.tenants = {t.name: t for t in tenants}
        if len(self.tenants) != len(tenants):
            raise ValueError("duplicate tenant names")
        self.admission_margin = float(admission_margin)
        self.min_admit_frac = float(min_admit_frac)
        self.min_link_share = float(min_link_share)
        self.headroom_boost = float(headroom_boost)
        super().__init__(drift, **kw)
        # ONE calibrator for the whole fleet, probe dedup on: a broad VoI
        # sweep skips links any tenant measured inside the window, so the
        # fleet runs ONE default-sized round per boundary where N isolated
        # services would each run their own. Coverage of the union of
        # tenant subgraphs comes from the targeted confirmation probes the
        # calibrated loop fires at contention-masked links (the shared
        # data plane makes masking common in a fleet), not from scaling
        # the sweep budget by N.
        if self.calibrate and kw.get("calibrator") is None:
            self.calibrator = Calibrator(
                self.belief, dedup_window_s=float(probe_dedup_window_s),
            )
        # req.name -> tenant name (requests stay tenant-agnostic)
        self._tenant_of: dict[str, str] = {}
        # tenant name -> full-grid [V,V] agg share (np.inf = uncapped),
        # rebuilt at every admission wave; rides re-plans as agg_scale
        self._tenant_shares: dict[str, np.ndarray] = {}
        self._deferred: dict[str, float] = {}  # req.name -> deferred-to t
        # jobs goal-backed-off to fit a VM quota (the executor's shared
        # clamp set — the fleet reads it for per-tenant reporting)
        self._quota_clamped = self._vm_clamped
        # tenant -> re-plans that ran on a borrowed (pooled) VM budget
        self._quota_borrows: dict[str, int] = {}
        self._live_states: list[_JobState] = []
        self._active_tenant: str | None = None
        self._admitting = False
        self._probe_turn = 0  # rotating per-tenant sweep focus

    # ------------------------------------------------------------- submission
    def submit(self, req: TransferRequest,
               tenant: str | None = None) -> TransferRequest:
        if tenant is None:
            if len(self.tenants) != 1:
                raise ValueError("multi-tenant fleet: submit(..., tenant=)")
            tenant = next(iter(self.tenants))
        if tenant not in self.tenants:
            raise KeyError(f"unknown tenant {tenant!r}")
        if req.name in self._tenant_of:
            raise ValueError(f"duplicate job name {req.name!r}")
        self._tenant_of[req.name] = tenant
        return super().submit(req)

    # ------------------------------------------------------- per-tenant cuts
    def _spec_extras(self) -> dict:
        """Inject the active tenant's fair-share ``agg_scale`` into every
        RE-plan solve. Admission-wave solves stay cut-free (the wave's
        sharing is done on the goal side, so the cohort batches)."""
        if self._admitting or self._active_tenant is None:
            return {}
        share = self._tenant_shares.get(self._active_tenant)
        if share is None or not np.isfinite(share).any():
            return {}
        return {"agg_scale": share}

    def _plan_spec(self, req, goal, volume_gb, *, vm_caps=None, constrained):
        self._active_tenant = self._tenant_of.get(req.name)
        return super()._plan_spec(req, goal, volume_gb, vm_caps=vm_caps,
                                  constrained=constrained)

    def _capacity(self, req, *, vm_caps=None) -> float:
        self._active_tenant = self._tenant_of.get(req.name)
        return super()._capacity(req, vm_caps=vm_caps)

    # --------------------------------------------------------------- admission
    def _route_edges(self, req) -> list[tuple[int, int]]:
        """Full-grid candidate edges of the request's pruned subgraph —
        the links its plans could ever ride (same notion the calibrator
        uses for probe candidates)."""
        if req.multicast:
            sub, s, ds, keep = self.planner._prune_mc(req.src, list(req.dsts))
            edges = sub.edge_list(s, None)
        else:
            sub, s, t, keep = self.planner._prune(req.src, req.dst)
            edges = sub.edge_list(s, t)
        return [(keep[a], keep[b]) for a, b in edges]

    def _route_key(self, req):
        return (req.src, tuple(req.dsts)) if req.multicast \
            else (req.src, req.dst)

    def _admission(self, reqs: list[TransferRequest]) -> dict[str, float]:
        """Admission control: the goal each request is admitted at.

        Deadline-class jobs first, at their requested goal. Bulk jobs in
        submission order take what fits under ``admission_margin`` of
        their route's remaining capacity; a job squeezed below
        ``min_admit_frac`` of its request is deferred instead — arrival
        pushed past the estimated drain of the wave ahead of it, full
        goal restored.

        Admission is then work-conserving: capacity the wave leaves
        unclaimed under the margin is granted back to the admitted jobs
        pro-rata by tenant weight, up to ``headroom_boost`` x each
        request. This is the consolidation dividend an isolated
        per-tenant service cannot take — it must treat the request as a
        cap because it cannot see the other tenants' demand on the
        shared links, while the fleet knows the residual is genuinely
        idle this wave."""
        cap_cache: dict = {}
        committed: dict = {}  # route -> Gbps already admitted
        queued_gb: dict = {}  # route -> volume ahead of a deferred job

        def route_cap(req) -> float:
            key = self._route_key(req)
            if key not in cap_cache:
                cap_cache[key] = float(np.sum(self._capacity(req)))
            return cap_cache[key]

        def klass(req) -> str:
            if req.deadline_s is not None:
                return "deadline"
            return self.tenants[self._tenant_of[req.name]].slo_class

        goals: dict[str, float] = {}
        ordered = [r for r in reqs if klass(r) == "deadline"] + \
                  [r for r in reqs if klass(r) != "deadline"]
        for req in ordered:
            key = self._route_key(req)
            cap = route_cap(req)
            room = self.admission_margin * cap - committed.get(key, 0.0)
            want = float(np.sum(np.asarray(req.tput_goal_gbps, dtype=float)))
            if klass(req) == "deadline":
                goal = min(want, max(room, self.min_admit_frac * want))
            elif room >= self.min_admit_frac * want:
                goal = min(want, room)
            else:
                # defer: plan at full goal for the wave after the queue
                # ahead of it drains (capacity estimate, not a promise —
                # the data plane arbitrates the truth)
                ahead_gb = queued_gb.get(key, 0.0)
                drain_s = ahead_gb * GBIT_PER_GB / max(cap, _EPS)
                req.arrival_s = max(req.arrival_s, drain_s)
                self._deferred[req.name] = req.arrival_s
                goal = want
                REGISTRY.counter("fleet.deferrals").inc()
                tr = get_tracer()
                if tr.enabled:
                    tr.instant("fleet.deferral", float(req.arrival_s),
                               track="fleet", job=req.name)
            goals[req.name] = goal
            committed[key] = committed.get(key, 0.0) + (
                goal if req.name not in self._deferred else 0.0
            )
            queued_gb[key] = queued_gb.get(key, 0.0) + req.volume_gb
        # ---- work conservation: hand the wave's unclaimed margin back
        if self.headroom_boost > 1.0:
            by_route: dict = {}
            for req in reqs:
                if req.name not in self._deferred:
                    by_route.setdefault(self._route_key(req), []).append(req)
            for key, members in by_route.items():
                leftover = (self.admission_margin * cap_cache[key]
                            - committed.get(key, 0.0))
                if leftover <= _EPS:
                    continue
                wants = [
                    float(np.sum(np.asarray(r.tput_goal_gbps, dtype=float)))
                    for r in members
                ]
                extra = [max(self.headroom_boost * w - goals[r.name], 0.0)
                         for r, w in zip(members, wants)]
                weights = [
                    self.tenants[self._tenant_of[r.name]].weight
                    for r in members
                ]
                for r, grant in zip(
                    members, weighted_max_min(weights, extra, leftover)
                ):
                    goals[r.name] += grant
                    committed[key] = committed.get(key, 0.0) + grant
        return goals

    def _fair_shares(
        self, reqs: list[TransferRequest], goals: dict[str, float]
    ) -> dict[str, np.ndarray]:
        """Per-tenant full-grid aggregate link shares (np.inf = uncapped).

        Per contended link — summed admitted demand above the shared-link
        capacity — deadline demand is carved out first (submission
        order), then bulk jobs water-fill the residual with weights
        ``tenant.weight / n_tenant_jobs`` (so a tenant's total share is
        weight-proportional however it splits its jobs). Uncontended
        links stay uncapped: agg rows are emitted only where the fleet
        actually arbitrated."""
        V = len(self.top.keys())
        tput = np.asarray(self.top.tput, dtype=float)
        lcs = float(self.link_capacity_scale or 1.0)
        shares = {t: np.full((V, V), np.inf) for t in self.tenants}
        by_req = {r.name: r for r in reqs}
        # link -> list of (job name, demand fraction of link capacity)
        users: dict[tuple[int, int], list[str]] = {}
        n_jobs = {t: 0 for t in self.tenants}
        for req in reqs:
            n_jobs[self._tenant_of[req.name]] += 1
            for e in self._route_edges(req):
                users.setdefault(e, []).append(req.name)
        for (a, b), names in users.items():
            cap = lcs * tput[a, b]
            if cap <= _EPS or len(names) < 2:
                continue
            demand = {n: min(goals[n] / cap, 1.0) for n in names}
            if sum(demand.values()) <= 1.0 + _EPS:
                continue  # uncontended: no cut
            dl = [n for n in names if by_req[n].deadline_s is not None
                  or self.tenants[self._tenant_of[n]].slo_class
                  == "deadline"]
            bulk = [n for n in names if n not in dl]
            alloc: dict[str, float] = {}
            residual = 1.0
            for n in dl:  # deadline demand carved out first
                alloc[n] = min(demand[n], residual)
                residual -= alloc[n]
            if bulk:
                w = [self.tenants[self._tenant_of[n]].weight
                     / max(n_jobs[self._tenant_of[n]], 1) for n in bulk]
                d = [demand[n] for n in bulk]
                for n, a_frac in zip(bulk, weighted_max_min(w, d, residual)):
                    alloc[n] = a_frac
            per_tenant: dict[str, float] = {}
            for n, frac in alloc.items():
                t = self._tenant_of[n]
                per_tenant[t] = per_tenant.get(t, 0.0) + frac
            for t, frac in per_tenant.items():
                shares[t][a, b] = max(frac, self.min_link_share)
        return shares

    def _admit_queue(self) -> list[_JobState]:
        """The fleet's admission wave, replacing one-planner-call-per-job:

        1. admission control clamps/defers goals against route capacity;
        2. weighted max-min link shares are fixed for the wave (they ride
           every later re-plan as ``agg_scale`` cuts);
        3. the whole cohort is planned in ONE ``plan_cohort`` sweep
           (batched where the specs are batchable), cut-free — the
           wave's arbitration already happened on the goal side.

        States come back in submission order (fault scripts and reports
        address jobs by that index)."""
        reqs, self._queue = self._queue, []
        for r in reqs:
            if r.name not in self._tenant_of:
                raise ValueError(
                    f"job {r.name!r} was queued without a tenant"
                )
        goals = self._admission(reqs)
        REGISTRY.counter("fleet.admission_waves").inc()
        tr = get_tracer()
        if tr.enabled:
            tr.instant("fleet.admission_wave", 0.0, track="fleet",
                       jobs=len(reqs), deferred=len(self._deferred))
        self._tenant_shares = self._fair_shares(reqs, goals)
        self._admitting = True
        try:
            specs = [
                self._plan_spec(
                    r,
                    goals[r.name] / (len(r.dsts) if r.multicast else 1),
                    r.volume_gb, constrained=False,
                )
                for r in reqs
            ]
            plans = self.planner.plan_cohort(specs)
            states = []
            for req, plan in zip(reqs, plans):
                plan = self._enforce_quota(req, plan, goals[req.name])
                # the admitted goal IS the job's goal from here on: every
                # re-plan targets what admission granted (boost included),
                # not the original request
                req.tput_goal_gbps = (
                    goals[req.name] / len(req.dsts) if req.multicast
                    else goals[req.name]
                )
                states.append(self._state_for(req, plan))
        finally:
            self._admitting = False
        # the run loop owns the states; the fleet keeps a reference so
        # quota borrowing can see which jobs still hold VMs at re-plan time
        self._live_states = states
        return states

    def _enforce_quota(self, req, plan, goal: float):
        """Goal backoff until the plan fits the tenant's VM quota — the
        admission-wave entry point of the executor's ``_fit_vm_budget``."""
        return self._fit_vm_budget(req, plan, goal, req.volume_gb,
                                   constrained=False)

    def _vm_budget_for(self, req):
        """Per-tenant VM quota, with idle-pool borrowing on re-plans.

        At admission every tenant is held to its OWN subscription quota —
        the wave is full, there is nothing idle to lend. A RE-plan may
        instead provision up to the pooled fleet quota minus what other
        still-active quota'd jobs hold: a tenant whose recovery plan
        needs more VMs than its subscription allows borrows the idle
        quota of tenants that already drained. This is the consolidation
        dividend an isolated service structurally cannot take — its
        subscription limit is a wall, not a pool."""
        spec = self.tenants.get(self._tenant_of.get(req.name, ""))
        if spec is None or spec.vm_quota is None:
            return self.vm_budget
        if self._admitting or not self._live_states:
            return float(spec.vm_quota)
        pool = sum(float(t.vm_quota) for t in self.tenants.values()
                   if t.vm_quota is not None)
        # a tenant with ANY live job keeps its whole subscription reserved
        # (its plans may scale back up); only drained tenants lend quota
        busy = {
            self._tenant_of[st.req.name] for st in self._live_states
            if st.status in ("planned", "running") and st.remaining_chunks
        }
        reserved = sum(
            float(t.vm_quota) for name, t in self.tenants.items()
            if t.vm_quota is not None
            and name != self._tenant_of.get(req.name)
            and name in busy
        )
        eff = max(float(spec.vm_quota), pool - reserved)
        if eff > float(spec.vm_quota) + _EPS:
            t = self._tenant_of[req.name]
            self._quota_borrows[t] = self._quota_borrows.get(t, 0) + 1
            REGISTRY.counter("fleet.quota_borrows").inc()
        return eff

    def _probe_focus(self, states, act):
        """Rotating per-tenant sweep focus.

        One default-sized probe round per boundary, concentrated on a
        single tenant's candidate subgraph — the same per-round attention
        an isolated service gives its own links, time-multiplexed across
        the fleet instead of multiplied by it. Ranking the UNION of every
        tenant's candidates under one round's budget dilutes each
        tenant's plan links below the probe cut; focusing restores the
        isolated service's detection latency at a third of its spend.
        A hit on a shared link still rescues every tenant riding it: the
        probe's sample feeds every active job's drift check through the
        shared belief."""
        order = sorted({self._tenant_of[states[i].req.name] for i in act})
        if not order:
            return super()._probe_focus(states, act)
        focus = order[self._probe_turn % len(order)]
        self._probe_turn += 1
        sel = [i for i in act
               if self._tenant_of[states[i].req.name] == focus]
        ctxs = [
            (states[i].req.src, states[i].req.dsts)
            if states[i].req.multicast
            else (states[i].req.src, states[i].req.dst)
            for i in sel
        ]
        return ctxs, [states[i].plan for i in sel]

    def _deadline_checks(self, states, now: float) -> None:
        """Boundary hook: the inherited deadline ladder first, then quota
        upgrades — a VM-clamped job re-plans on the pooled budget once
        enough idle quota has appeared to matter (≥ 1 whole VM beyond its
        current plan). The re-plan rides the cached structures like every
        other re-plan (zero re-assembly); its record carries
        ``reason="quota-borrow"``."""
        super()._deadline_checks(states, now)
        for i, st in enumerate(states):
            if st.req.name not in self._quota_clamped:
                continue
            if st.status not in ("planned", "running") \
                    or not st.remaining_chunks:
                continue
            want = float(np.sum(np.asarray(
                st.req.tput_goal_gbps, dtype=float)))
            if float(st.plan.throughput) >= 0.95 * want:
                continue  # the clamp is not what is holding it back
            budget = self._vm_budget_for(st.req)
            if budget is None or budget < float(st.plan.num_vms) + 1.0:
                continue
            self._quota_clamped.discard(st.req.name)
            self._replan(st, i, at_s=now, reason="quota-borrow")
            self._post_replan(st)

    # ------------------------------------------------------------------ report
    def run(self, *args, **kwargs) -> FleetReport:
        base = super().run(*args, **kwargs)
        fields = {
            f.name: getattr(base, f.name)
            for f in dataclasses.fields(CalibratedServiceReport)
        }
        return FleetReport(
            **fields,
            tenants=self._tenant_reports(base),
            deferred_jobs=len(self._deferred),
        )

    def _tenant_reports(self, base) -> list[TenantReport]:
        probe_share = base.probe_cost_usd / max(len(self.tenants), 1)
        out = []
        for name, spec in self.tenants.items():
            jrs = [j for j in base.jobs
                   if self._tenant_of.get(j.request.name) == name]
            out.append(TenantReport(
                name=name, weight=spec.weight, slo_class=spec.slo_class,
                jobs=len(jrs),
                requested_gb=sum(j.request.volume_gb for j in jrs),
                delivered_gb=sum(j.delivered_gb for j in jrs),
                realized_cost=sum(j.realized_cost for j in jrs),
                deferred=sum(
                    1 for j in jrs if j.request.name in self._deferred
                ),
                quota_clamps=sum(
                    1 for j in jrs if j.request.name in self._quota_clamped
                ),
                deadline_misses=sum(
                    1 for j in jrs if j.deadline_met is False
                ),
                probe_cost_share_usd=probe_share,
                quota_borrows=self._quota_borrows.get(name, 0),
            ))
        return out
