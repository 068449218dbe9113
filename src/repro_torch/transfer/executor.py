"""Plan execution front-ends.

``execute_plan`` runs one TransferPlan on the fluid simulator and reconciles
realized cost/throughput against the planner's predictions (plus the
managed-service models for the Fig. 6 comparison).

``TransferService`` is the multi-tenant orchestrator on top: it
admits a queue of jobs, plans them with the batched ``backend="torch"``
solver, runs them concurrently on the multi-job simulator, and — when a
scripted fault degrades the topology mid-transfer — re-plans each affected
job's *remaining* volume. Re-planning rides entirely on the planner's
memoized pruned subgraphs and cached ``LPStructure``s: the degraded links
and unhealthy regions become extra constraint rows (``Planner._degrade_
cuts``), so no constraint matrix is ever re-assembled; tests pin
``milp.N_STRUCT_BUILDS`` across a re-plan to assert it.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np

from repro_torch.core import milp
from repro_torch.core.baselines import CloudServiceModel
from repro_torch.core.plan import MulticastPlan, TransferPlan
from repro_torch.core.planner import Planner
from repro_torch.core.spec import PlanSpec
from repro_torch.core.topology import GBIT_PER_GB, Topology
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import get_tracer

from .breaker import LinkBreaker
from .events import (
    T_EPS,
    GrayFailure,
    LinkDegrade,
    LinkRestore,
    TransferJob,
    VMFailure,
)
from .flowsim import SimResult, simulate_transfer
from .reports import Report


@dataclasses.dataclass
class ExecutionReport(Report):
    sim: SimResult
    planned_tput_gbps: float
    planned_cost: float
    tput_ratio: float  # achieved / planned
    cost_ratio: float  # realized / planned

    @property
    def time_s(self) -> float:
        return self.sim.time_s

    kind = "execution"
    _summary_keys = ("time_s", "realized_tput_gbps", "tput_ratio",
                     "cost_ratio")

    def _payload(self) -> dict:
        return {
            "time_s": self.time_s,
            "planned_tput_gbps": self.planned_tput_gbps,
            "realized_tput_gbps": self.sim.tput_gbps,
            "planned_cost": self.planned_cost,
            "realized_cost": self.sim.total_cost,
            "tput_ratio": self.tput_ratio,
            "cost_ratio": self.cost_ratio,
        }


def execute_plan(plan: TransferPlan, **sim_kwargs) -> ExecutionReport:
    sim = simulate_transfer(plan, **sim_kwargs)
    return ExecutionReport(
        sim=sim,
        planned_tput_gbps=plan.throughput,
        planned_cost=plan.total_cost,
        tput_ratio=sim.tput_gbps / max(plan.throughput, 1e-9),
        cost_ratio=sim.total_cost / max(plan.total_cost, 1e-9),
    )


def execute_service_model(
    model: CloudServiceModel, top: Topology, src: str, dst: str, volume_gb: float
) -> dict:
    t = model.transfer_time_s(top, src, dst, volume_gb)
    return {
        "service": model.name,
        "time_s": t,
        "tput_gbps": volume_gb * 8.0 / t,
        "cost": model.cost(top, src, dst, volume_gb),
    }


# ------------------------------------------------------------------- service
@dataclasses.dataclass
class TransferRequest:
    """One tenant job submitted to the TransferService.

    ``dsts`` switches the job to one-to-many replication: the service plans
    a single multicast transfer to every listed destination (``dst`` is
    ignored) with ``tput_goal_gbps`` as the per-destination floor.

    ``deadline_s`` (relative to ``arrival_s``) declares a completion SLO:
    the service sheds work down the :class:`DegradationLadder` under
    deadline pressure and, at the deadline itself, cuts the job to an
    explicit partial delivery instead of running late. ``retry_budget``
    caps chunk retries — exhaustion also ends in a ``"partial"`` report
    with the delivered byte count intact, never silent loss. Both default
    to None: no deadline, unlimited retries — exactly today's semantics."""

    name: str
    src: str
    dst: str
    volume_gb: float
    tput_goal_gbps: float
    arrival_s: float = 0.0
    chunk_mb: float = 16.0
    dsts: list[str] | None = None
    deadline_s: float | None = None
    retry_budget: int | None = None

    @property
    def multicast(self) -> bool:
        return self.dsts is not None


@dataclasses.dataclass(frozen=True)
class BackoffLadder:
    """Named goal-backoff schedule for constrained re-plans.

    When a re-plan at the capacity-capped goal is infeasible, the service
    walks ``factors`` (each a multiplier on that base goal) until a rung
    solves. The default reproduces the halving ladder the service always
    had, but as data: benchmarks can pin an aggressive single-rung ladder,
    tests can enumerate the exact sequence, and ``ReplanRecord.ladder``
    names which schedule produced each record."""

    name: str = "halving"
    factors: tuple[float, ...] = (1.0, 0.5, 0.25)

    def goals(self, base_goal: float) -> list[float]:
        return [base_goal * f for f in self.factors]


@dataclasses.dataclass(frozen=True)
class DegradationLadder:
    """What a deadline-pressured job sheds, in order, before giving up.

    At each segment boundary the service compares the job's ETA (at the
    more pessimistic of planned and realized throughput) against the time
    left; when ``eta * pressure`` exceeds it, the job climbs one rung:

      * ``"shed_robustness"`` — re-plan at z=0: stop paying the belief's
        lower-confidence-bound safety margin for headroom;
      * ``"shed_trickle"``    — re-plan and drop paths below
        ``trickle_frac`` of plan throughput: a slow path's in-flight
        chunks gate every boundary drain, a latency tax a deadline job
        cannot afford;
      * ``"partial"``         — stop: report partial delivery now rather
        than miss the deadline by more.

    Rungs are sticky — every later re-plan of the job keeps the shed."""

    steps: tuple[str, ...] = ("shed_robustness", "shed_trickle", "partial")
    pressure: float = 1.0  # >1 escalates earlier (safety margin on the ETA)
    trickle_frac: float = 0.25


def _drop_trickle_paths(plan, frac: float = 0.05):
    """Drop decomposed paths below ``frac`` of plan throughput and
    rebuild F. A trickle path over a collapsed link is rational to the
    LP (the re-plan goal sits at 95% of robust capacity, so the solver
    scrapes every capped drop) but poisonous to the segmented data
    plane: its in-flight chunks crawl, and every boundary drain waits
    for them — a latency tax far above the capacity the path adds."""
    if isinstance(plan, MulticastPlan):
        return plan
    paths = plan.paths()
    total = sum(f for _, f in paths)
    keep = [(p, f) for p, f in paths if f >= frac * total]
    if not keep or len(keep) == len(paths):
        return plan
    F = np.zeros_like(plan.F)
    for p, f in keep:
        for a, b in zip(p[:-1], p[1:]):
            F[a, b] += f
    plan.F = F
    plan.tput_goal = min(plan.tput_goal, float(F[plan.src, :].sum()))
    return plan


@dataclasses.dataclass
class ReplanRecord:
    job: str
    at_s: float
    remaining_gb: float
    latency_s: float
    structure_builds: int  # LPStructure assemblies during the re-plan
    plan: TransferPlan
    goal_gbps: float = 0.0  # throughput goal the accepted re-plan ran at
    backoffs: int = 0  # times the goal was backed off before success
    ladder: str = "halving"  # BackoffLadder.name that produced the goals
    reason: str = "fault"  # "fault" | "deadline" | "quarantine"

    @property
    def reused_structure(self) -> bool:
        """True when the re-plan was a pure cache hit (no LP re-assembly)."""
        return self.structure_builds == 0

    @property
    def degraded_slo(self) -> bool:
        """True when the re-plan only succeeded at a backed-off goal."""
        return self.backoffs > 0


@dataclasses.dataclass
class JobReport(Report):
    request: TransferRequest
    plan: TransferPlan  # the job's current (possibly re-planned) allocation
    status: str  # "done" | "stalled" | "failed" | "running" | "partial"
    planned_tput_gbps: float
    planned_cost: float
    realized_tput_gbps: float
    realized_cost: float
    delivered_gb: float
    retried_chunks: int
    contended: bool  # realized tput fell below the contention threshold
    replans: list[ReplanRecord]
    deadline_met: bool | None = None  # None when no deadline was requested
    budget_exhausted: bool = False  # retry budget spent -> partial delivery
    degrade_level: int = 0  # DegradationLadder rungs climbed
    n_chunks: int = 0  # total chunks the request chunked into
    delivered_chunks: int = 0  # chunks landed (== n_chunks iff done)

    @property
    def tput_ratio(self) -> float:
        return self.realized_tput_gbps / max(self.planned_tput_gbps, 1e-9)

    @property
    def cost_ratio(self) -> float:
        return self.realized_cost / max(self.planned_cost, 1e-9)

    @property
    def lost_chunks(self) -> int:
        """Chunks neither delivered nor accounted by an explicit partial/
        failed/stalled/running status. Nonzero means silent loss — the
        integrity invariant every chaos scenario must keep at zero."""
        if self.status != "done":
            return 0  # undelivered remainder is explicit, not lost
        return self.n_chunks - self.delivered_chunks

    kind = "job"
    _summary_keys = ("name", "status", "delivered_gb", "realized_tput_gbps",
                     "replans", "deadline_met")

    def _payload(self) -> dict:
        return {
            "name": self.request.name,
            "status": self.status,
            "planned_tput_gbps": self.planned_tput_gbps,
            "realized_tput_gbps": self.realized_tput_gbps,
            "planned_cost": self.planned_cost,
            "realized_cost": self.realized_cost,
            "delivered_gb": self.delivered_gb,
            "n_chunks": self.n_chunks,
            "delivered_chunks": self.delivered_chunks,
            "retried_chunks": self.retried_chunks,
            "lost_chunks": self.lost_chunks,
            "contended": self.contended,
            "replans": len(self.replans),
            "replan_struct_builds": sum(
                r.structure_builds for r in self.replans
            ),
            "deadline_met": self.deadline_met,
            "budget_exhausted": self.budget_exhausted,
            "degrade_level": self.degrade_level,
        }


@dataclasses.dataclass
class ServiceReport(Report):
    jobs: list[JobReport]
    time_s: float
    segments: int
    sim_events: int
    # breaker audit trail: every open/half-open/close transition
    quarantines: list = dataclasses.field(default_factory=list)

    @property
    def replans(self) -> list[ReplanRecord]:
        return [r for j in self.jobs for r in j.replans]

    @property
    def all_done(self) -> bool:
        return all(j.status == "done" for j in self.jobs)

    @property
    def partial_jobs(self) -> list[JobReport]:
        return [j for j in self.jobs if j.status == "partial"]

    @property
    def slo_violations(self) -> int:
        """Jobs that requested a deadline and missed it (late or partial)."""
        return sum(1 for j in self.jobs if j.deadline_met is False)

    @property
    def slo_violation_rate(self) -> float:
        with_slo = [j for j in self.jobs if j.request.deadline_s is not None]
        if not with_slo:
            return 0.0
        return sum(1 for j in with_slo if j.deadline_met is False) / len(with_slo)

    kind = "service"
    _summary_keys = ("jobs", "time_s", "delivered_gb", "segments",
                     "slo_violations")
    _metrics_prefixes = ("planner.", "service.", "breaker.")

    def _payload(self) -> dict:
        return {
            "jobs": len(self.jobs),
            "time_s": self.time_s,
            "segments": self.segments,
            "sim_events": self.sim_events,
            "delivered_gb": sum(j.delivered_gb for j in self.jobs),
            "all_done": self.all_done,
            "slo_violations": self.slo_violations,
            "slo_violation_rate": self.slo_violation_rate,
            "replans": len(self.replans),
            "replan_struct_builds": sum(
                r.structure_builds for r in self.replans
            ),
            "quarantines": len(self.quarantines),
            "per_job": [j.to_dict() for j in self.jobs],
        }


@dataclasses.dataclass
class _JobState:
    req: TransferRequest
    plan: TransferPlan  # or MulticastPlan for one-to-many jobs
    chunk_gbit: float
    remaining_chunks: int  # multicast: chunks the slowest branch still needs
    n_chunks: int
    planned_tput0: float = 0.0  # the admission-time plan's predictions
    planned_cost0: float = 0.0
    delivered_chunks: int = 0
    realized_cost: float = 0.0
    retried_chunks: int = 0
    finished_at: float | None = None
    status: str = "queued"
    degrade_level: int = 0  # DegradationLadder rungs climbed so far
    budget_exhausted: bool = False
    replans: list = dataclasses.field(default_factory=list)
    # multicast: cumulative chunks per destination region (capped at
    # n_chunks) — a full destination drops out of the next re-plan's goals,
    # so only the surviving branches are re-planned
    delivered_by_dst: dict = dataclasses.field(default_factory=dict)

    @property
    def remaining_gb(self) -> float:
        # half-chunk shave so re-chunking the remainder reproduces the
        # integer chunk count exactly (ceil is not float-robust at the edge)
        return max(self.remaining_chunks - 0.5, 0.5) * self.chunk_gbit / GBIT_PER_GB

    def dst_done(self, d: int) -> bool:
        return self.delivered_by_dst.get(d, 0) >= self.n_chunks


class TransferService:
    """Fault-tolerant multi-job transfer orchestrator.

    Usage::

        svc = TransferService(top, backend="torch")
        svc.submit(TransferRequest("job-a", src, dst, 8.0, 4.0))
        report = svc.run(faults=[LinkDegrade(t_s=5.0, src=s, dst=t, factor=0.3)])

    ``run`` simulates all admitted jobs concurrently on the multi-job fluid
    data plane, segmenting the timeline at each scripted fault: the fault is
    folded into the service's degraded-topology view, every affected
    unfinished job has its remaining volume re-planned under the degraded
    constraints (cached-structure refit), and the data plane resumes with
    the new allocations. Accumulated link degradations also throttle the
    simulator itself, so un-replanned jobs feel them too.

    Re-planning is chunk-granular: chunks in flight at a segment boundary
    restart under the new allocation (their partial bytes were already
    billed — the same semantics as the gateway re-dispatching a chunk whose
    worker died). A fault landing within one chunk-ETA of the previous one
    can therefore show zero delivered chunks for the short segment.

    Multicast jobs (``TransferRequest(dsts=[...])``) are admitted as ONE
    one-to-many plan; on a fault, only the surviving branches are
    re-planned — destinations that already hold every chunk get a zero
    goal on the same cached structure and drop out of the trees.

    Where it runs is the caller's choice, never the hardware's: ``device``
    (None = the CUDA card, raising where there is none) is the planner's
    torch device for ``backend="torch"`` solves and the sim's for
    ``engine="torch"``; ``engine`` picks ``transfer.sim.simulate``'s
    engine (``"ref"`` and ``"soa"`` are numpy and ignore ``device``).
    Constrained re-plans solve on the sequential numpy backend, as
    admissions do under a degraded view.
    """

    def __init__(
        self,
        top: Topology,
        *,
        backend: str = "torch",
        device=None,
        engine: str = "torch",
        max_relays: int = 10,
        contention_ratio: float = 0.5,
        backoff_ladder: BackoffLadder | None = None,
        degradation: DegradationLadder | None = None,
        breaker: LinkBreaker | None = None,
        vm_budget: float | None = None,
    ):
        self.top = top
        self.backend = backend
        self.device = device
        self.engine = engine
        self.planner = Planner(top, max_relays=max_relays, device=device)
        self.contention_ratio = contention_ratio
        # the deployment's VM instance quota: no single plan of this
        # service may provision more VMs than the subscription allows.
        # None = uncapped. Enforced by goal backoff on every admission
        # and re-plan solve (_fit_vm_budget).
        self.vm_budget = vm_budget if vm_budget is None else float(vm_budget)
        self._vm_clamped: set[str] = set()
        self.backoff_ladder = (
            backoff_ladder if backoff_ladder is not None else BackoffLadder()
        )
        self.degradation = degradation
        self.breaker = breaker
        self._queue: list[TransferRequest] = []
        # degraded-topology view, accumulated across faults. Link health is
        # physical and shared by every tenant; VM loss is per job (job 0's
        # dead gateways say nothing about job 1's quota in that region).
        self.degraded_links: dict[tuple[int, int], float] = {}
        self.vm_caps_by_job: dict[int, dict[int, float]] = {}
        # gray view: rate multipliers the service does NOT know about —
        # GrayFailures fold here so the simulator keeps feeling them across
        # segment boundaries while plans stay blissfully on the healthy view
        self._gray: dict[tuple[int, int], float] = {}
        # link health stashed while the breaker quarantines it (the view
        # pins at 0.0; degrades/restores keep compounding on the shadow)
        self._pre_quarantine: dict[tuple[int, int], float] = {}
        # deadline-shedding state, set around re-plans of degraded jobs
        self._replan_z: float | None = None
        self._replan_trickle: float | None = None

    def submit(self, req: TransferRequest) -> TransferRequest:
        self._queue.append(req)
        return req

    # ------------------------------------------------------------------ run
    def _plan_scale(self) -> np.ndarray | None:
        """Full-grid [V,V] throughput scale every solve should plan under,
        or None. The base service trusts its grid; the calibration plane
        overrides this with the belief's lower-confidence-bound scale so
        every admission and re-plan is uncertainty-aware — the scale rides
        the cached LP structures as extra rows (zero re-assembly)."""
        return None

    def _spec_extras(self) -> dict:
        """Extra ``PlanSpec`` fields every solve of this service carries.

        The base service has none; the fleet controller injects its
        per-tenant ``agg_scale`` fair-share caps here so admission and
        re-plans alike respect the tenant's link shares."""
        return {}

    def _plan_spec(self, req: TransferRequest, goal, volume_gb: float,
                   *, vm_caps=None, constrained: bool) -> PlanSpec:
        """The ``PlanSpec`` for one admission/re-plan solve of ``req``."""
        common = dict(
            objective="cost_min",
            src=req.src,
            volume_gb=volume_gb,
            degraded_links=(dict(self.degraded_links)
                            if constrained and self.degraded_links else None),
            vm_caps=(dict(vm_caps)
                     if constrained and vm_caps else None),
            tput_scale=self._plan_scale(),
            **self._spec_extras(),
        )
        if req.multicast:
            goals = goal if np.ndim(goal) else float(goal)
            return PlanSpec(dsts=tuple(req.dsts), tput_goal_gbps=goals,
                            **common)
        return PlanSpec(
            dst=req.dst, tput_goal_gbps=float(goal),
            backend="numpy" if constrained else self.backend, **common,
        )

    def _plan_for(self, req: TransferRequest, goal: float, volume_gb: float,
                  *, vm_caps=None, constrained: bool) -> TransferPlan:
        """One admission/re-plan solve for either job flavor. A multicast
        re-plan only carries goals for the destinations still missing
        chunks, so faulted branches are re-planned and finished ones
        dropped — on the SAME cached structure (goals are pure RHS)."""
        plan = self.planner.plan(self._plan_spec(
            req, goal, volume_gb, vm_caps=vm_caps, constrained=constrained,
        ))
        if (
            not req.multicast
            and self._replan_trickle is not None
            and plan.solver_status == "optimal"
        ):
            # deadline shedding: a pressured job refuses slow paths
            plan = _drop_trickle_paths(plan, self._replan_trickle)
        return plan

    def _capacity(self, req: TransferRequest, *, vm_caps=None) -> float:
        common = dict(
            objective="max_throughput",
            src=req.src,
            degraded_links=dict(self.degraded_links) or None,
            vm_caps=dict(vm_caps) if vm_caps else None,
            tput_scale=self._plan_scale(),
            **self._spec_extras(),
        )
        if req.multicast:
            return self.planner.plan(PlanSpec(dsts=tuple(req.dsts), **common))
        return self.planner.plan(PlanSpec(dst=req.dst, **common))

    def _vm_budget_for(self, req: TransferRequest) -> float | None:
        """VM ceiling for one plan of ``req`` — the deployment's instance
        quota. The base service applies its flat ``vm_budget`` (the
        subscription limit an isolated tenant cannot exceed); the fleet
        controller overrides this with per-tenant quotas plus idle-pool
        borrowing."""
        return self.vm_budget

    def _fit_vm_budget(self, req: TransferRequest, plan, goal,
                       volume_gb: float, *, vm_caps=None, constrained):
        """Goal backoff until the plan fits the VM ceiling.

        VM counts are ceil-of-flow OUTPUTS of the LP, not constraint
        rows, so a quota cannot ride the cached structures as a cut —
        backing the throughput goal off (pure RHS, zero re-assembly) is
        how the budget is honored without a structure rebuild. If a
        backed-off solve goes infeasible the last optimal (over-budget)
        plan is kept: a quota violation the operator can see beats a
        failed job."""
        budget = self._vm_budget_for(req)
        if budget is None or plan.solver_status != "optimal":
            return plan
        g = goal
        for _ in range(4):
            if plan.num_vms <= budget + 1e-9:
                return plan
            shrink = max(min(budget / max(plan.num_vms, 1e-9), 0.75), 0.1)
            g = ([float(x) * shrink for x in g] if np.ndim(g)
                 else float(g) * shrink)
            self._vm_clamped.add(req.name)
            nxt = self._plan_for(req, g, volume_gb,
                                 vm_caps=vm_caps, constrained=constrained)
            if nxt.solver_status != "optimal":
                break
            plan = nxt
        return plan

    def _admit(self, req: TransferRequest) -> _JobState:
        if self.degraded_links or self._plan_scale() is not None:
            # the service already carries degraded links from earlier runs:
            # new tenants must be planned (and their predictions priced)
            # against that view, or they are flagged contended forever and
            # nothing ever re-routes them (constrained solves run on the
            # sequential backend; still a cached-structure refit)
            cap = self._capacity(req)
            goal = min(req.tput_goal_gbps, max(cap, 1e-9) * 0.95)
            plan = self._plan_for(req, goal, req.volume_gb, constrained=True)
            plan = self._fit_vm_budget(req, plan, goal, req.volume_gb,
                                       constrained=True)
        else:
            plan = self._plan_for(req, req.tput_goal_gbps, req.volume_gb,
                                  constrained=False)
            plan = self._fit_vm_budget(req, plan, req.tput_goal_gbps,
                                       req.volume_gb, constrained=False)
        return self._state_for(req, plan)

    def _state_for(self, req: TransferRequest, plan) -> _JobState:
        """Chunk the request and wrap its plan as a fresh job state."""
        cg = req.chunk_mb * 8.0 / 1024.0
        n_chunks = max(1, int(np.ceil(req.volume_gb * GBIT_PER_GB / cg)))
        st = _JobState(req=req, plan=plan, chunk_gbit=cg,
                       remaining_chunks=n_chunks, n_chunks=n_chunks,
                       planned_tput0=plan.throughput,
                       planned_cost0=plan.total_cost)
        st.status = "planned" if plan.solver_status == "optimal" else "failed"
        return st

    def _admit_queue(self) -> list[_JobState]:
        """Admission hook: turn the queued requests into job states, in
        submission order (fault scripts address jobs by that index). The
        base service admits everything with one planner call per job; the
        fleet controller overrides this with admission control, weighted
        fair shares, and one batched cohort solve."""
        states = [self._admit(r) for r in self._queue]
        self._queue = []
        return states

    def _replan(
        self, st: _JobState, job_ix: int, at_s: float, reason: str = "fault"
    ) -> None:
        req = st.req
        vm_caps = self.vm_caps_by_job.get(job_ix, {})
        t0 = time.perf_counter()
        builds0 = milp.N_STRUCT_BUILDS
        # deadline-pressure shedding is sticky: every re-plan of a degraded
        # job keeps the rungs it has climbed (z=0 / trickle-free plans)
        climbed: tuple[str, ...] = ()
        if self.degradation is not None and st.degrade_level > 0:
            climbed = self.degradation.steps[: st.degrade_level]
        self._replan_z = 0.0 if "shed_robustness" in climbed else None
        self._replan_trickle = (
            self.degradation.trickle_frac
            if "shed_trickle" in climbed else None
        )
        try:
            cap = self._capacity(req, vm_caps=vm_caps)
            if cap <= 1e-9:
                st.status = "failed"
                return
            base_goal = min(req.tput_goal_gbps, cap * 0.95)
            # A non-optimal constrained solve does not mean the job is
            # dead: a lower throughput goal may still be feasible on the
            # degraded topology. Walk the backoff ladder before declaring
            # failure; the record keeps the degraded SLO visible.
            goal, plan, backoffs = base_goal, None, 0
            fit_goal = base_goal
            for backoff, g in enumerate(self.backoff_ladder.goals(base_goal)):
                # the record reports the LAST goal actually attempted,
                # whether or not it was accepted
                goal, backoffs = g, backoff
                if req.multicast:
                    goals = [
                        0.0 if st.dst_done(self.top.index(d)) else g
                        for d in req.dsts
                    ]
                    if not any(goals):
                        return  # every branch already delivered in full
                    g_try = goals
                else:
                    g_try = g
                plan = self._plan_for(req, g_try, st.remaining_gb,
                                      vm_caps=vm_caps, constrained=True)
                fit_goal = g_try
                if plan.solver_status == "optimal":
                    break
            if plan is not None and plan.solver_status == "optimal":
                plan = self._fit_vm_budget(req, plan, fit_goal,
                                           st.remaining_gb,
                                           vm_caps=vm_caps, constrained=True)
        finally:
            self._replan_z = None
            self._replan_trickle = None
        rec = ReplanRecord(
            job=req.name,
            at_s=at_s,
            remaining_gb=st.remaining_gb,
            latency_s=time.perf_counter() - t0,
            structure_builds=milp.N_STRUCT_BUILDS - builds0,
            plan=plan,
            goal_gbps=goal,
            backoffs=backoffs,
            ladder=self.backoff_ladder.name,
            reason=reason,
        )
        st.replans.append(rec)
        REGISTRY.counter("service.replans").inc()
        tr = get_tracer()
        if tr.enabled:
            tr.instant("service.replan", float(at_s), track="service",
                       job=req.name, reason=reason,
                       struct_builds=rec.structure_builds)
        if plan.solver_status == "optimal":
            st.plan = plan
        else:
            st.status = "failed"

    def _post_replan(self, st: _JobState) -> None:
        """Hook for subclasses to refresh per-plan caches after a re-plan
        issued outside their own run loop (deadline/quarantine paths)."""

    # ------------------------------------------------------- chaos policies
    def _quarantine(self, key: tuple[int, int]) -> None:
        """Open-breaker quarantine: pin the link's degraded-view factor to
        0.0 — the planner turns that into ``extra_ub = 0`` rows on the
        CACHED structures, so no plan can route a byte over it and no
        constraint matrix is re-assembled. The link's real health keeps
        compounding on a shadow entry for when the breaker closes."""
        self._pre_quarantine[key] = self.degraded_links.get(key, 1.0)
        self.degraded_links[key] = 0.0
        REGISTRY.counter("service.quarantines").inc()

    def _unquarantine(self, key: tuple[int, int]) -> None:
        phi = self._pre_quarantine.pop(key, 1.0)
        if phi >= 1.0 - 1e-9:
            self.degraded_links.pop(key, None)
        else:
            self.degraded_links[key] = phi

    def _deadline_checks(self, states: list[_JobState], now: float) -> None:
        """At a segment boundary, escalate deadline-pressured jobs one rung
        down the degradation ladder — or cut them to partial delivery at
        the deadline itself. Jobs without a deadline are never touched."""
        for i, st in enumerate(states):
            if st.req.deadline_s is None:
                continue
            if st.status not in ("planned", "running") or not st.remaining_chunks:
                continue
            time_left = st.req.arrival_s + st.req.deadline_s - now
            if time_left <= T_EPS:
                # the deadline has passed with chunks outstanding: an
                # explicit partial delivery beats an unbounded overrun
                st.status = "partial"
                continue
            if self.degradation is None:
                continue
            rate = max(float(st.plan.throughput), 1e-9)
            elapsed = now - st.req.arrival_s
            if st.delivered_chunks > 0 and elapsed > T_EPS:
                realized = st.delivered_chunks * st.chunk_gbit / elapsed
                rate = min(rate, max(realized, 1e-9))
            eta = st.remaining_chunks * st.chunk_gbit / rate
            if eta * self.degradation.pressure <= time_left:
                continue
            if st.degrade_level >= len(self.degradation.steps):
                continue
            st.degrade_level += 1
            step = self.degradation.steps[st.degrade_level - 1]
            if step == "partial":
                st.status = "partial"
            else:
                self._replan(st, i, at_s=now, reason="deadline")
                self._post_replan(st)

    def _sim_faults(self) -> list:
        """The degraded + gray views as t=0 events for the simulator. The
        gray entries re-inject the silent slowdowns the service does not
        know about — both fold to the same rate multiply in the sim, the
        split only matters to the control plane."""
        evs: list = [
            LinkDegrade(t_s=0.0, src=a, dst=b, factor=phi)
            for (a, b), phi in self.degraded_links.items()
        ]
        evs += [
            GrayFailure(t_s=0.0, src=a, dst=b, factor=g)
            for (a, b), g in self._gray.items()
        ]
        return evs

    def _fold_segment(
        self, active: list[_JobState], res, now: float, *,
        restart: bool = False,
    ) -> None:
        """Fold one simulated segment's per-job results into job state
        (delivered/remaining chunks, realized cost, retries, status).

        ``restart=True`` marks a segment cut at a fault boundary: chunks
        in flight at the cut restart from scratch under the next plan, so
        they count against the job's retry budget — the fluid analogue of
        the gateway re-dispatching chunks whose worker died mid-copy."""
        for st, jr in zip(active, res.jobs):
            st.delivered_chunks += jr.chunks_delivered
            st.remaining_chunks -= jr.chunks_delivered
            st.realized_cost += jr.total_cost
            st.retried_chunks += jr.retried_chunks
            if restart and jr.status == "running":
                st.retried_chunks += jr.chunks_in_flight
            if jr.per_dst_delivered:
                for d, cnt in jr.per_dst_delivered.items():
                    st.delivered_by_dst[d] = min(
                        st.n_chunks,
                        st.delivered_by_dst.get(d, 0) + cnt,
                    )
            if jr.status == "done":
                st.status = "done"
                st.finished_at = (
                    now + max(st.req.arrival_s - now, 0.0) + jr.time_s
                )
            elif jr.status == "stalled":
                st.status = "stalled"
            elif jr.status == "running":
                st.status = "running"
            if (
                st.req.retry_budget is not None
                and st.retried_chunks > st.req.retry_budget
                and st.remaining_chunks > 0
            ):
                # budget exhausted with chunks outstanding: explicit
                # partial delivery, delivered count intact — never silent
                st.status = "partial"
                st.budget_exhausted = True

    def _job_reports(self, states: list[_JobState], now: float) -> list[JobReport]:
        """Final per-job reports from terminal (or horizon-cut) job state."""
        reports = []
        for st in states:
            delivered_gb = st.delivered_chunks * st.chunk_gbit / GBIT_PER_GB
            end = st.finished_at if st.finished_at is not None else now
            dur = max(end - st.req.arrival_s, 1e-9)
            realized_tput = st.delivered_chunks * st.chunk_gbit / dur
            status = st.status
            if status == "planned":  # never simulated (no active segment)
                status = "queued"
            if st.req.deadline_s is None:
                deadline_met = None
            else:
                deadline_met = (
                    status == "done"
                    and st.finished_at is not None
                    and st.finished_at - st.req.arrival_s
                    <= st.req.deadline_s + 1e-9
                )
            reports.append(JobReport(
                request=st.req,
                plan=st.plan,
                status=status,
                planned_tput_gbps=st.planned_tput0,
                planned_cost=st.planned_cost0,
                realized_tput_gbps=realized_tput,
                realized_cost=st.realized_cost,
                delivered_gb=delivered_gb,
                retried_chunks=st.retried_chunks,
                contended=(
                    status == "done"
                    and realized_tput
                    < self.contention_ratio * st.planned_tput0
                ),
                replans=st.replans,
                deadline_met=deadline_met,
                budget_exhausted=st.budget_exhausted,
                degrade_level=st.degrade_level,
                n_chunks=st.n_chunks,
                delivered_chunks=st.delivered_chunks,
            ))
        return reports

    def run(
        self,
        faults=(),
        *,
        seed: int = 0,
        link_capacity_scale: float | None = 2.0,
        sim=None,
        **sim_kwargs,
    ) -> ServiceReport:
        """Plan, execute and (on faults) re-plan every submitted job.

        ``faults`` are service-level events (events.LinkDegrade /
        events.LinkRestore / events.GrayFailure / events.VMFailure with
        absolute times); ``sim`` overrides the simulator entry point
        (defaults to transfer.sim.simulate on the service's ``engine`` and
        ``device`` — the reference oracle drops in for cross-checks). A
        caller's ``sim`` gets the segment's arguments and ``sim_kwargs``
        only, not the service's engine or device.

        Visible events segment the timeline and fold into the degraded
        view (re-planning affected jobs); GrayFailures are SILENT — they
        reach the simulator so the data plane feels them, but never the
        planner's view, never a segment boundary, never a re-plan. That
        asymmetry is the whole gray-failure story: only telemetry (or a
        breaker fed by it) can catch what the control plane cannot see."""
        from .sim import simulate

        sim = sim or functools.partial(
            simulate, engine=self.engine, device=self.device
        )
        states = self._admit_queue()
        visible = [f for f in faults if not isinstance(f, GrayFailure)]
        silent = sorted(
            (f for f in faults if isinstance(f, GrayFailure)),
            key=lambda f: f.t_s,
        )
        boundaries = sorted({float(f.t_s) for f in visible})
        by_time: dict[float, list] = {}
        for f in visible:
            by_time.setdefault(float(f.t_s), []).append(f)

        now = 0.0
        sim_events = 0
        segments = 0
        seg_end = 0.0
        for seg, boundary in enumerate(boundaries + [None]):
            # gray events already behind us compound into the gray view
            # (re-injected at t=0 each segment); upcoming ones within this
            # segment ride along at sim-relative times
            while silent and silent[0].t_s < now - T_EPS:
                f = silent.pop(0)
                key = (f.src, f.dst)
                g = self._gray.get(key, 1.0) * f.factor
                if abs(g - 1.0) <= 1e-9:
                    self._gray.pop(key, None)  # silent recovery healed it
                else:
                    self._gray[key] = g
            seg_silent = [
                dataclasses.replace(f, t_s=max(f.t_s - now, 0.0))
                for f in silent
                if boundary is None or f.t_s < boundary - T_EPS
            ]
            active = [
                st for st in states
                if st.status in ("planned", "running") and st.remaining_chunks
            ]
            if active:
                segments += 1
                sim_jobs = [
                    TransferJob(
                        plan=st.plan.with_volume(st.remaining_gb),
                        name=st.req.name,
                        arrival_s=max(st.req.arrival_s - now, 0.0),
                        chunk_mb=st.req.chunk_mb,
                    )
                    for st in active
                ]
                res = sim(
                    sim_jobs, self._sim_faults() + seg_silent,
                    horizon_s=None if boundary is None else boundary - now,
                    seed=seed + 101 * seg,
                    link_capacity_scale=link_capacity_scale,
                    **sim_kwargs,
                )
                sim_events += res.events
                self._fold_segment(active, res, now,
                                   restart=boundary is not None)
                seg_end = now + res.time_s
                tr = get_tracer()
                if tr.enabled:
                    tr.span("service.segment", now, res.time_s,
                            track="service", seg=seg, jobs=len(active),
                            sim_events=res.events)
            else:
                seg_end = now

            if boundary is None:
                now = seg_end
                break
            if not any(
                st.status in ("planned", "running") and st.remaining_chunks
                for st in states
            ):
                # everything terminal before the next fault: later faults
                # change nothing, and the makespan is the real sim end, not
                # the last scripted fault time
                now = seg_end
                break
            now = boundary

            # ---- breaker: cooldowns that elapsed by this boundary get
            # their half-open health check (the base service's stand-in
            # probe: did a visible restore arrive since the open?)
            if self.breaker is not None:
                for key in self.breaker.due_half_open(now):
                    healthy = self.breaker.restore_seen(key)
                    self.breaker.half_open_result(key, now, healthy)
                    if healthy:
                        self._unquarantine(key)
                        for i, st in enumerate(states):
                            if (
                                st.status in ("planned", "running")
                                and st.remaining_chunks
                            ):
                                self._replan(st, i, at_s=now,
                                             reason="quarantine")
                                self._post_replan(st)

            # ---- fold the fault(s) into the degraded-topology view
            affected: set[int] = set()

            def _mark_users(src: int, dst: int) -> None:
                for i, st in enumerate(states):
                    # a multicast job rides the link iff its envelope
                    # does (the bytes actually on the wire)
                    used = (
                        st.plan.G[src, dst]
                        if isinstance(st.plan, MulticastPlan)
                        else st.plan.F[src, dst]
                    )
                    if used > 1e-9:
                        affected.add(i)

            for f in by_time[boundary]:
                if isinstance(f, LinkDegrade):
                    key = (f.src, f.dst)
                    quarantined = (
                        self.breaker is not None
                        and self.breaker.is_quarantined(key)
                    )
                    if quarantined:
                        # the view stays pinned at 0.0; health compounds
                        # on the shadow for when the breaker closes
                        self._pre_quarantine[key] = (
                            self._pre_quarantine.get(key, 1.0) * f.factor
                        )
                    else:
                        self.degraded_links[key] = (
                            self.degraded_links.get(key, 1.0) * f.factor
                        )
                        _mark_users(f.src, f.dst)
                    if self.breaker is not None:
                        if self.breaker.record_failure(key, now) and (
                            not quarantined
                        ):
                            self._quarantine(key)
                            tr = get_tracer()
                            if tr.enabled:
                                tr.instant(
                                    "service.quarantine", now,
                                    track="service",
                                    link=f"{key[0]}->{key[1]}",
                                )
                            _mark_users(f.src, f.dst)
                elif isinstance(f, LinkRestore):
                    key = (f.src, f.dst)
                    if (
                        self.breaker is not None
                        and self.breaker.is_quarantined(key)
                    ):
                        self._pre_quarantine[key] = min(
                            self._pre_quarantine.get(key, 1.0) * f.factor,
                            1.0,
                        )
                        self.breaker.note_restore(key, now)
                    else:
                        phi = min(
                            self.degraded_links.get(key, 1.0) * f.factor, 1.0
                        )
                        if phi >= 1.0 - 1e-9:
                            self.degraded_links.pop(key, None)
                        else:
                            self.degraded_links[key] = phi
                        # restored capacity is worth re-optimizing for —
                        # every active job may want the healed link back
                        # (the no-breaker baseline's trap under flapping)
                        for i, st in enumerate(states):
                            affected.add(i)
                elif isinstance(f, VMFailure):
                    caps = self.vm_caps_by_job.setdefault(f.job, {})
                    lost = caps.get(f.region, float(self.top.limit_vm)) - f.count
                    caps[f.region] = max(lost, 0.0)
                    if 0 <= f.job < len(states):
                        affected.add(f.job)
                else:
                    raise TypeError(f"unknown fault {f!r}")
            for i in sorted(affected):
                st = states[i]
                if st.status in ("planned", "running") and st.remaining_chunks:
                    self._replan(st, i, at_s=boundary)
                    self._post_replan(st)

            # ---- deadline SLOs: escalate pressured jobs down the ladder
            self._deadline_checks(states, now)

        return ServiceReport(
            jobs=self._job_reports(states, now), time_s=now,
            segments=segments, sim_events=sim_events,
            quarantines=(
                list(self.breaker.transitions)
                if self.breaker is not None else []
            ),
        )
