"""CalibratedTransferService: the closed measure→believe→plan→observe loop.

Extends :class:`repro_torch.transfer.TransferService` with the calibration
plane's split view of the world:

  * plans are made on the BELIEVED topology (``BeliefGrid`` mean at
    service start — the epoch grid) with the ``robustness`` knob applied:
    every admission and re-plan rides the belief's lower-confidence-bound
    scale as tightened 4b rows on the CACHED LP structures
    (``TransferService._plan_scale`` override; zero re-assembly);
  * the data plane executes on the TRUE topology (``DriftModel`` snapshot
    frozen at each segment start, via ``simulate(exec_top=...)`` on the
    service's ``engine`` and ``device``);
  * the run is segmented every ``check_interval_s``: at each boundary a
    ``Calibrator`` probe round spends its budget on the highest
    value-of-information links, and passive telemetry (per-link delivered
    GB over active seconds) folds into the belief;
  * a drift detector compares what a plan assumed of each link it uses
    against what probes and telemetry observed: a sample below
    ``drift_ratio`` of the assumption AND outside the belief's
    z-confidence band (``BeliefGrid.out_of_bounds``) flags the link, the
    belief is updated at ``drift_weight``, and the job's REMAINING volume
    is re-planned (``TransferService._replan`` — cached structures, goal
    backoff ladder, ``ReplanRecord`` provenance all inherited).

A long transfer that crosses a step-change incident therefore finishes
near its SLO — the loop routes the remainder around the collapsed link —
where the same service with ``calibrate=False`` (the stale-grid baseline:
same segmentation, same true topology, no probes / no belief updates / no
re-planning) limps through at the incident's rate.

Beliefs can also IMPROVE past the epoch grid (a link recovers, or the
stale profile undersold it). Mid-epoch the planner cannot exploit that:
scale cuts only tighten (phi clips at 1.0 — a loosening row never binds).
The service therefore watches the flow-weighted believed/epoch ratio over
the links its plans ride and, past a hysteresis threshold, performs an
**epoch roll**: re-pin the epoch grid at the belief mean, rebuild the LP
structures on it (the one sanctioned, counted re-assembly), and re-plan
every active job's remaining volume at its full requested goal. Rolls are
rare by construction — the threshold gates them, each roll resets the
ratio to ~1, and ``max_epoch_rolls`` bounds them per run.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core import milp
from repro_torch.core.plan import MulticastPlan
from repro_torch.core.planner import Planner
from repro_torch.core.topology import GBIT_PER_GB
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import get_tracer
from repro_torch.transfer.events import TransferJob
from repro_torch.transfer.executor import (
    ReplanRecord,
    ServiceReport,
    TransferService,
    _drop_trickle_paths,
)

from .belief import BeliefGrid, capacity_sample_from_rates
from .calibrator import Calibrator, ProbeRound
from .drift import DriftModel
from .policies import ProbePolicy

_FLOW_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """One detected believed-vs-observed divergence on a plan link."""

    t_s: float
    job: str
    src: int  # region indices of the drifted link
    dst: int
    assumed_gbps: float  # what the job's plan assumed of the link
    observed_gbps: float  # the capacity sample that broke the bounds
    source: str  # "probe" | "telemetry"


@dataclasses.dataclass(frozen=True)
class EpochRoll:
    """One epoch roll: the belief mean re-pinned as the planner's grid.

    The roll is the sanctioned exception to the zero-re-assembly rule —
    it deliberately rebuilds LP structures on the improved grid, and
    ``structure_builds`` counts exactly how many assemblies it bought
    (bounded by the roll cap; drift re-plans still assemble nothing)."""

    t_s: float  # segment boundary the roll fired at
    ratio: float  # flow-weighted believed/epoch ratio that triggered it
    structure_builds: int
    replans: list[ReplanRecord]  # the roll's re-plans (kept out of
    # JobReport.replans so the zero-build invariant there stays meaningful)


@dataclasses.dataclass
class CalibratedServiceReport(ServiceReport):
    probe_rounds: list[ProbeRound] = dataclasses.field(default_factory=list)
    drift_events: list[DriftEvent] = dataclasses.field(default_factory=list)
    # (t_s, mean relative believed-vs-true grid error) per probe round
    belief_error_trajectory: list[tuple[float, float]] = dataclasses.field(
        default_factory=list
    )
    epoch_rolls: list[EpochRoll] = dataclasses.field(default_factory=list)
    boundaries: list[float] = dataclasses.field(default_factory=list)
    # segment end times — epoch rolls may only fire on these

    @property
    def probe_cost_usd(self) -> float:
        return sum(r.cost_usd for r in self.probe_rounds)

    @property
    def probe_seconds(self) -> float:
        return sum(r.duration_s for r in self.probe_rounds)

    @property
    def epoch_roll_builds(self) -> int:
        return sum(r.structure_builds for r in self.epoch_rolls)

    kind = "calibrated_service"
    _summary_keys = ("jobs", "time_s", "delivered_gb", "probe_cost_usd",
                     "drift_events", "epoch_rolls")
    _metrics_prefixes = ("planner.", "service.", "breaker.", "calibrate.")

    def _payload(self) -> dict:
        d = super()._payload()
        d.update({
            "probe_rounds": len(self.probe_rounds),
            "probe_cost_usd": self.probe_cost_usd,
            "probe_seconds": self.probe_seconds,
            "probes_deduped": sum(
                getattr(r, "deduped", 0) for r in self.probe_rounds
            ),
            "drift_events": len(self.drift_events),
            "epoch_rolls": len(self.epoch_rolls),
            "epoch_roll_builds": self.epoch_roll_builds,
            "belief_error_final": (
                self.belief_error_trajectory[-1][1]
                if self.belief_error_trajectory else None
            ),
        })
        return d


class CalibratedTransferService(TransferService):
    """TransferService planning on a belief, executing on a drift model.

    Usage::

        drift = DriftModel(default_topology(), seed=3, incidents=[...])
        svc = CalibratedTransferService(drift)
        svc.submit(TransferRequest("big", src, dst, 64.0, 4.0))
        report = svc.run()

    ``calibrate=False`` turns every feedback path off (no probes, no
    telemetry, no drift detection, no re-planning) while keeping the
    identical segmented execution on the true topology — the stale-grid
    baseline the calibration benchmark compares against.
    """

    def __init__(
        self,
        drift: DriftModel,
        *,
        belief: BeliefGrid | None = None,
        calibrator: Calibrator | None = None,
        calibrate: bool = True,
        robustness: float = 1.5,
        check_interval_s: float = 4.0,
        drift_ratio: float = 0.6,
        drift_z: float = 2.0,
        passive_weight: float = 1.0,
        drift_weight: float = 8.0,
        max_segments: int = 400,
        link_capacity_scale: float | None = 2.0,
        policy: ProbePolicy | str | None = None,
        epoch_roll_threshold: float = 1.15,
        max_epoch_rolls: int = 2,
        **kw,
    ):
        self.drift = drift
        self.belief = belief or BeliefGrid(drift.base)
        self.calibrate = bool(calibrate)
        self.robustness = float(robustness)
        self.check_interval_s = float(check_interval_s)
        self.drift_ratio = float(drift_ratio)
        self.drift_z = float(drift_z)
        self.passive_weight = float(passive_weight)
        self.drift_weight = float(drift_weight)
        self.max_segments = int(max_segments)
        self.link_capacity_scale = link_capacity_scale
        self.epoch_roll_threshold = float(epoch_roll_threshold)
        self.max_epoch_rolls = int(max_epoch_rolls)
        # the epoch grid: plans are priced and constrained against the
        # belief mean frozen at service construction; within the epoch the
        # belief moves only through scale cuts (zero re-assembly)
        super().__init__(self.belief.believed_topology(), **kw)
        self.planner.belief = self.belief
        # robust cuts also cap aggregate flow on drifted links at the data
        # plane's shared-link capacity — an incident cannot be bought back
        # with more VMs/connections (matches the sim's water-filling)
        self.planner.link_capacity_scale = link_capacity_scale
        self.calibrator = calibrator if calibrator is not None else (
            Calibrator(self.belief, policy=policy) if self.calibrate else None
        )
        # contention-masked links _harvest flagged for a targeted
        # confirmation probe at the next boundary: oversubscription scales
        # the telemetry expectation down, so a capacity collapse hiding
        # under the mask is invisible to passive sampling — only a
        # saturating probe can tell contention from drift there
        self._confirm_links: set[tuple[int, int]] = set()

    # --------------------------------------------------------------- planning
    def _plan_scale(self) -> np.ndarray | None:
        """The belief's lower-confidence-bound scale vs the epoch grid —
        what every admission/re-plan solve rides as cached-structure cuts.
        None while the belief still matches the epoch (no cuts needed) or
        when calibration is off (the stale baseline trusts its grid)."""
        if not self.calibrate:
            return None
        # deadline shedding may strip the robustness margin for headroom:
        # z=0 plans on the belief mean instead of its lower bound
        z = self.robustness if self._replan_z is None else float(self._replan_z)
        phi = self.belief.scale_grid(self.top, z=max(z, 0.0))
        if (phi >= 1.0 - 1e-9).all():
            return None
        return phi

    # kept as a staticmethod alias — the implementation moved next to the
    # deadline-shedding machinery that also needs it
    _drop_trickle_paths = staticmethod(_drop_trickle_paths)

    def _plan_for(self, req, goal, volume_gb, *, vm_caps=None, constrained):
        plan = super()._plan_for(req, goal, volume_gb,
                                 vm_caps=vm_caps, constrained=constrained)
        if self.calibrate and plan.solver_status == "optimal":
            plan = self._drop_trickle_paths(plan)
        return plan

    def _post_replan(self, st) -> None:
        """Re-plans issued by the shared deadline/quarantine machinery must
        refresh the drift detector's reference grid like the run loop's
        own re-plan sites do."""
        if st.status != "failed":
            st._assumed = self._assumed_grid(st.plan)

    def _assumed_grid(self, plan) -> np.ndarray:
        """Per-link throughput the plan effectively assumed: the epoch grid
        under the scale active when the plan was made, masked to the links
        the plan uses. The drift detector's reference point."""
        grid = plan.G if isinstance(plan, MulticastPlan) else plan.F
        scale = self._plan_scale()
        eff = np.asarray(self.top.tput, dtype=float)
        if scale is not None:
            eff = eff * scale
        return np.where(np.asarray(grid) > _FLOW_EPS, eff, 0.0)

    # ------------------------------------------------------------ epoch rolls
    def _epoch_headroom(self, states_active) -> float:
        """Flow-weighted believed/epoch throughput ratio over the links the
        active plans actually ride. > 1 means the belief has risen past
        the epoch-pinned grid there — capacity the planner cannot exploit
        mid-epoch because scale cuts clip at 1.0."""
        epoch = np.asarray(self.top.tput, dtype=float)
        num = den = 0.0
        for st in states_active:
            g = np.asarray(
                st.plan.G if isinstance(st.plan, MulticastPlan) else st.plan.F
            )
            m = (g > _FLOW_EPS) & (epoch > 0)
            if not m.any():
                continue
            w = g[m]
            num += float((w * (self.belief.mean[m] / epoch[m])).sum())
            den += float(w.sum())
        return num / den if den > 0 else 1.0

    def _roll_epoch(self, states, act, t_s: float, ratio: float) -> EpochRoll:
        """Re-pin the epoch grid at the improved belief mean.

        This is the one place the calibration plane is ALLOWED to rebuild
        LP structures: the new epoch topology gets fresh caches, every
        active job's remaining volume is re-planned on them at its full
        requested goal, and the assemblies that bought are counted on the
        roll record (drift re-plans before and after stay zero-build).
        The roll's re-plans live on the roll, not in ``JobReport.replans``."""
        builds0 = milp.N_STRUCT_BUILDS
        self.belief.roll_epoch()
        self.top = self.belief.believed_topology()
        planner = Planner(self.top, max_relays=self.planner.max_relays,
                          device=self.device)
        planner.belief = self.belief
        planner.link_capacity_scale = self.link_capacity_scale
        self.planner = planner
        recs: list[ReplanRecord] = []
        for i in act:
            st = states[i]
            n0 = len(st.replans)
            self._replan(st, i, at_s=t_s)
            if len(st.replans) > n0:
                recs.append(st.replans.pop())
            if st.status != "failed":
                st._assumed = self._assumed_grid(st.plan)
        roll = EpochRoll(
            t_s=float(t_s), ratio=float(ratio),
            structure_builds=milp.N_STRUCT_BUILDS - builds0,
            replans=recs,
        )
        REGISTRY.counter("calibrate.epoch_rolls").inc()
        tr = get_tracer()
        if tr.enabled:
            tr.instant("calibrate.epoch_roll", float(t_s), track="calibrate",
                       ratio=round(float(ratio), 4),
                       struct_builds=roll.structure_builds)
        return roll

    # ----------------------------------------------------------------- checks
    def _probe_focus(self, states, act):
        """(contexts, plans) the boundary's VoI sweep should rank over.

        The base service sweeps every active job's candidate subgraph.
        The fleet controller overrides this with a rotating per-tenant
        focus so one default-sized round concentrates on one tenant's
        links instead of diluting across the union."""
        ctxs = [
            (states[i].req.src, states[i].req.dsts)
            if states[i].req.multicast
            else (states[i].req.src, states[i].req.dst)
            for i in act
        ]
        return ctxs, [states[i].plan for i in act]

    def _probe_drifted_links(
        self, st, samples: dict[tuple[int, int], float]
    ) -> list[tuple[int, int, float, float]]:
        """(a, b, assumed, measured) for every plan link an active probe
        measured far below what the plan assumed of it (grid space). A
        probe saturates the link, so its measurement needs no confidence
        band to be trusted — the ratio alone convicts."""
        out = []
        for (a, b), obs in samples.items():
            assumed = float(st._assumed[a, b])
            if assumed <= _FLOW_EPS:
                continue
            if obs < self.drift_ratio * assumed:
                out.append((a, b, assumed, obs))
        return out

    def _harvest(
        self, st, jr, t_s: float = 0.0,
        agg_grid: np.ndarray | None = None,
    ) -> tuple[dict[tuple[int, int], float],
               list[tuple[int, int, float, float]]]:
        """Passive telemetry: per-link capacity samples for the links this
        job's segment actually exercised, folded into the belief with
        change-point handling (``observe_adaptive`` — a step change is a
        new regime, not one more noisy draw of the old one).

        Returns (samples, drifted links). A link drifts when it delivered
        below ``drift_ratio`` of the flow the plan allocated on it AND its
        capacity sample falls outside the belief's confidence band — the
        band is evaluated BEFORE the sample is folded in, because a
        change-point reset moves the band onto the sample.

        ``agg_grid`` is the AGGREGATE allocation across every job in the
        segment: when co-tenants over-subscribe a shared link beyond the
        believed interconnect capacity, this job's fair share — not its
        solo allocation — is what the data plane owes it, and reading the
        shortfall as capacity drift would reset healthy links low."""
        plan = st.plan
        grid = plan.G if isinstance(plan, MulticastPlan) else plan.F
        samples: dict[tuple[int, int], float] = {}
        hits: list[tuple[int, int, float, float]] = []
        busy_map = jr.per_edge_active_s or {}
        obs_map = jr.per_edge_obs_gb
        default_busy = 0.0
        if obs_map is None:
            # simulator without the obs window (e.g. the flowsim_ref
            # oracle via sim=): fall back to whole-run bytes over the
            # job's whole duration — a cruder, dilution-prone window,
            # but it keeps passive telemetry live on every backend
            obs_map = jr.per_edge_gb or {}
            default_busy = float(jr.time_s)
        for key, gb in obs_map.items():
            a_s, b_s = key.split("->")
            a, b = int(a_s), int(b_s)
            busy = float(busy_map.get(key, default_busy))
            if busy <= 1e-6:
                continue
            observed = gb * GBIT_PER_GB / busy
            expected = float(grid[a, b])
            if agg_grid is not None and self.link_capacity_scale is not None:
                cap_now = self.link_capacity_scale * float(
                    self.belief.mean[a, b]
                )
                agg = float(agg_grid[a, b])
                if agg > cap_now > 0.0:
                    # known contention, not drift — but a link that ALSO
                    # underdelivers against its unmasked expectation may be
                    # collapsing underneath the oversubscription. Passive
                    # telemetry cannot tell (the mask absorbs the shortfall);
                    # flag it for a targeted saturating probe next boundary.
                    if observed < self.drift_ratio * expected:
                        self._confirm_links.add((a, b))
                    expected *= cap_now / agg
            sample = capacity_sample_from_rates(
                observed, expected,
                n_vms=max(float(np.round(plan.N[a])), 1.0),
                link_capacity_scale=self.link_capacity_scale,
            )
            if sample is None:
                continue  # link kept up with the plan: no capacity info
            samples[(a, b)] = sample
            if (
                observed < self.drift_ratio * expected
                and st._assumed[a, b] > _FLOW_EPS
                and self.belief.out_of_bounds(a, b, sample, z=self.drift_z)
            ):
                hits.append((a, b, expected, observed))
        for (a, b), sample in samples.items():
            self.belief.observe_adaptive(
                a, b, sample,
                weight=self.passive_weight, z_reset=self.drift_z,
                t_s=t_s,
            )
        return samples, hits

    # -------------------------------------------------------------------- run
    def run(
        self,
        faults=(),
        *,
        seed: int = 0,
        link_capacity_scale: float | None = None,
        sim=None,
        **sim_kwargs,
    ) -> CalibratedServiceReport:
        """Segmented execution on the drifting true topology.

        Scripted ``faults`` are not supported here — incidents belong to
        the DriftModel (the service must *discover* them through probes
        and telemetry, which is the whole point).

        ``sim`` overrides the simulator entry point (defaults to
        transfer.sim.simulate on the service's ``engine`` and ``device``).
        A caller's ``sim`` gets the segment's arguments and ``sim_kwargs``
        only, not the service's engine or device."""
        from repro_torch.transfer.sim import simulate

        if faults:
            raise ValueError(
                "CalibratedTransferService takes no scripted faults; "
                "script incidents on the DriftModel instead"
            )
        sim = sim or functools.partial(
            simulate, engine=self.engine, device=self.device
        )
        if link_capacity_scale is None:
            link_capacity_scale = self.link_capacity_scale
        states = self._admit_queue()
        for st in states:
            st._assumed = self._assumed_grid(st.plan)

        probe_rounds: list[ProbeRound] = []
        drift_events: list[DriftEvent] = []
        trajectory: list[tuple[float, float]] = []
        epoch_rolls: list[EpochRoll] = []
        boundaries: list[float] = []
        now = 0.0
        segments = 0
        sim_events = 0

        def active_indices() -> list[int]:
            return [
                i for i, st in enumerate(states)
                if st.status in ("planned", "running") and st.remaining_chunks
            ]

        def note_drift(st, hits, t, source):
            tr = get_tracer()
            for a, b, assumed, obs in hits:
                drift_events.append(DriftEvent(
                    t_s=t, job=st.req.name, src=a, dst=b,
                    assumed_gbps=assumed, observed_gbps=obs, source=source,
                ))
                REGISTRY.counter("calibrate.drift_events").inc()
                if tr.enabled:
                    tr.instant("calibrate.drift", float(t),
                               track="calibrate", job=st.req.name,
                               link=f"{a}->{b}", source=source)

        def breaker_feed(hits, t) -> list[tuple[int, int]]:
            """Drift detections are the breaker's failure signal here.
            A link that trips open is quarantined on the planner view and
            reseeded in the belief at the observed collapsed rate — the
            regime changed, the old posterior is evidence about nothing."""
            opened: list[tuple[int, int]] = []
            if self.breaker is None:
                return opened
            tr = get_tracer()
            for a, b, _assumed, obs in hits:
                if self.breaker.record_failure((a, b), t):
                    self._quarantine((a, b))
                    if tr.enabled:
                        tr.instant("service.quarantine", float(t),
                                   track="service", link=f"{a}->{b}")
                    self.belief.reset_link(a, b, max(obs, 1e-6), t_s=t)
                    opened.append((a, b))
            return opened

        def replan_quarantined_users(opened, t) -> None:
            """Every still-active job riding a just-quarantined link gets
            its remainder re-planned off it (cached structures — the
            quarantine is an extra_ub=0 scale cut, not a rebuild)."""
            for a, b in opened:
                for i in active_indices():
                    st = states[i]
                    g = np.asarray(
                        st.plan.G if isinstance(st.plan, MulticastPlan)
                        else st.plan.F
                    )
                    if g[a, b] > _FLOW_EPS:
                        self._replan(st, i, at_s=t, reason="quarantine")
                        self._post_replan(st)

        while segments < self.max_segments:
            act = active_indices()
            if not act:
                break
            true_now = self.drift.tput_at(now)

            # ---- breaker: quarantined links past their cooldown get a
            # targeted half-open probe through the calibrator; the
            # measurement reseeds the belief either way (regime change),
            # and a healthy link rejoins the plannable topology
            if (
                self.calibrate
                and self.breaker is not None
                and self.calibrator is not None
            ):
                for key in self.breaker.due_half_open(now):
                    a, b = key
                    rnd = self.calibrator.run_round(now, true_now, links=[key])
                    probe_rounds.append(rnd)
                    trajectory.append((now, rnd.belief_error))
                    measured = (
                        rnd.records[0].measured_gbps if rnd.records else 0.0
                    )
                    healthy = (
                        measured
                        >= self.breaker.config.heal_ratio
                        * float(np.asarray(self.top.tput)[a, b])
                    )
                    self.belief.reset_link(a, b, max(measured, 1e-6), t_s=now)
                    self.breaker.half_open_result(key, now, healthy)
                    if healthy:
                        self._unquarantine(key)
                        for i in active_indices():
                            self._replan(states[i], i, at_s=now,
                                         reason="quarantine")
                            self._post_replan(states[i])

            # ---- probe round: spend the budget where VoI is highest
            if self.calibrate and self.calibrator is not None:
                samples: dict[tuple[int, int], float] = {}
                if self._confirm_links:
                    # targeted confirmation of contention-masked links (one
                    # or two links, not a sweep): the mask scaled their
                    # telemetry expectation down, so a collapse hiding under
                    # oversubscription never trips the passive detector —
                    # a saturating probe settles contention-vs-drift.
                    # Targeted rounds bypass the dedup window by design.
                    crnd = self.calibrator.run_round(
                        now, true_now, links=sorted(self._confirm_links),
                    )
                    self._confirm_links.clear()
                    probe_rounds.append(crnd)
                    trajectory.append((now, crnd.belief_error))
                    samples.update({
                        (r.src, r.dst): r.measured_gbps for r in crnd.records
                    })
                ctxs, cplans = self._probe_focus(states, act)
                rnd = self.calibrator.run_round(
                    now, true_now,
                    planner=self.planner,
                    contexts=ctxs,
                    plans=cplans,
                )
                probe_rounds.append(rnd)
                trajectory.append((now, rnd.belief_error))
                # probe-driven drift: a probed plan link measured far below
                # what the plan assumed re-plans BEFORE the segment runs
                samples.update({
                    (r.src, r.dst): r.measured_gbps for r in rnd.records
                })
                opened: list[tuple[int, int]] = []
                for i in act:
                    st = states[i]
                    hits = self._probe_drifted_links(st, samples)
                    if hits:
                        note_drift(st, hits, now, "probe")
                        opened += breaker_feed(hits, now)
                        self._replan(st, i, at_s=now)
                        if st.status != "failed":
                            st._assumed = self._assumed_grid(st.plan)
                replan_quarantined_users(opened, now)

            # ---- one segment on the true topology frozen at `now`
            act = active_indices()
            if not act:
                break
            exec_top = self.top.with_tput(true_now)
            active = [states[i] for i in act]
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
                sim_jobs, (),
                horizon_s=self.check_interval_s,
                seed=seed + 101 * segments,
                link_capacity_scale=link_capacity_scale,
                exec_top=exec_top,
                drain=True,
                **sim_kwargs,
            )
            segments += 1
            sim_events += res.events
            self._fold_segment(active, res, now)
            seg_end = now + res.time_s
            if res.time_s <= 1e-9:
                # every admitted job is still ahead of its arrival: jump
                # the clock to the next arrival instead of spinning the
                # segment counter at a frozen `now`
                pending = [st.req.arrival_s for st in active
                           if st.req.arrival_s > now + 1e-9]
                if pending:
                    seg_end = min(pending)
            boundaries.append(seg_end)
            tr = get_tracer()
            if tr.enabled:
                tr.span("service.segment", now, res.time_s,
                        track="service", seg=segments - 1,
                        jobs=len(active), sim_events=res.events)
                tr.instant("service.boundary", seg_end, track="service",
                           seg=segments - 1)

            # ---- feedback: telemetry -> belief -> drift -> re-plan
            if self.calibrate:
                agg = np.zeros_like(np.asarray(self.top.tput))
                for st in active:
                    g = (st.plan.G if isinstance(st.plan, MulticastPlan)
                         else st.plan.F)
                    agg = agg + np.asarray(g)
                opened = []
                drifted_links: set[tuple[int, int]] = set()
                replanned: set[int] = set()
                for i, jr in zip(act, res.jobs):
                    st = states[i]
                    _, hits = self._harvest(st, jr, t_s=seg_end,
                                            agg_grid=agg)
                    if hits:
                        drifted_links.update(
                            (a, b) for a, b, _, _ in hits
                        )
                    if (
                        hits
                        and st.status in ("planned", "running")
                        and st.remaining_chunks
                    ):
                        note_drift(st, hits, seg_end, "telemetry")
                        opened += breaker_feed(hits, seg_end)
                        self._replan(st, i, at_s=seg_end)
                        replanned.add(i)
                        if st.status != "failed":
                            st._assumed = self._assumed_grid(st.plan)
                # a convicted link re-routes EVERY plan riding it — a
                # co-tenant's telemetry may have been masked by known
                # contention, or its harvest ran after the first job's
                # change-point reset moved the belief onto the collapse
                for a, b in drifted_links:
                    for i in active_indices():
                        if i in replanned:
                            continue
                        st = states[i]
                        g = np.asarray(
                            st.plan.G
                            if isinstance(st.plan, MulticastPlan)
                            else st.plan.F
                        )
                        if g[a, b] > _FLOW_EPS:
                            note_drift(
                                st,
                                [(a, b, float(st._assumed[a, b]),
                                  float(self.belief.mean[a, b]))],
                                seg_end, "telemetry-shared",
                            )
                            self._replan(st, i, at_s=seg_end)
                            replanned.add(i)
                            self._post_replan(st)
                replan_quarantined_users(opened, seg_end)

            # ---- deadline SLOs: escalate pressured jobs down the ladder
            self._deadline_checks(states, seg_end)

            # ---- epoch roll: exploit a belief that rose past the epoch
            # grid. Only ever AT a segment boundary (never mid-segment),
            # only past the hysteresis threshold, and only up to the cap.
            if self.calibrate and len(epoch_rolls) < self.max_epoch_rolls:
                act = active_indices()
                if act:
                    ratio = self._epoch_headroom([states[i] for i in act])
                    if ratio >= self.epoch_roll_threshold:
                        epoch_rolls.append(
                            self._roll_epoch(states, act, seg_end, ratio)
                        )
            now = seg_end

        return CalibratedServiceReport(
            jobs=self._job_reports(states, now),
            time_s=now,
            segments=segments,
            sim_events=sim_events,
            quarantines=(
                list(self.breaker.transitions)
                if self.breaker is not None else []
            ),
            probe_rounds=probe_rounds,
            drift_events=drift_events,
            belief_error_trajectory=trajectory,
            epoch_rolls=epoch_rolls,
            boundaries=boundaries,
        )
