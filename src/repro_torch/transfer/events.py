"""Multi-job transfer scenarios: jobs, scripted faults, shared materialization.

The fault-tolerant data plane runs several concurrent
``TransferPlan``s against a scripted schedule of mid-transfer events:

  * ``TransferJob``   — one plan plus its arrival time and chunk size;
  * ``LinkDegrade``   — a region-pair link loses a fraction of its capacity
    (compounding: ``factor`` multiplies the *current* rates);
  * ``VMFailure``     — gateway VMs of one job die; their in-flight chunks
    are lost and re-dispatched to the surviving workers of the same stage
    (chunk-level retry, zero data loss while any worker survives);
  * ``GrayFailure``   — the chaos plane's silent partial failure: the same
    rate multiplication as ``LinkDegrade``, but no failure signal — the
    TransferService never folds it into its degraded view, only telemetry
    (or a circuit breaker fed by it) can catch the slowdown;
  * ``LinkRestore``   — visible recovery: the inverse multiplication of an
    earlier degrade; the service heals its degraded view (capped at full
    capacity) and circuit breakers read it as the up-edge of a flap.

All three rate events (``RATE_EVENTS``) are executed identically by both
simulators — a compounding multiply on the affected connections' rates and
the shared link cap — so the chaos suite's chunk-for-chunk parity holds
for every archetype ``transfer.chaos`` compiles down to them.

Every sim engine — the port's ``ref``, ``soa`` and ``torch`` and the
reference package's three — consumes the same ``materialize_jobs`` scenario (identical
per-job RNG streams, VM/connection materialization and chunk->path
assignment), so the equivalence tests can pin them together
chunk-for-chunk. The event loops themselves are implemented
independently.

Jobs contend for the wide-area links: each directed region pair is modelled
as a shared fluid resource with capacity ``link_capacity_scale`` times the
single-VM-pair grid rate, divided max-min fairly across every tenant's
connections (OneDataShare-style multi-job scheduling pressure).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.plan import MulticastPlan, TransferPlan
from repro_torch.core.topology import GBIT_PER_GB

from .flowsim import conn_efficiency

# One tolerance for every time comparison of the multi-job event loops
# (schedule due-ness, horizon cuts, final horizon classification). Both
# simulators — vectorized and reference — must use THIS constant: a
# boundary event classified differently on the two sides breaks the
# chunk-for-chunk equivalence the tests pin.
T_EPS = 1e-9


@dataclasses.dataclass
class TransferJob:
    """One tenant job of the multi-job data plane.

    ``plan`` is either a point-to-point ``TransferPlan`` or a one-to-many
    ``MulticastPlan`` — a multicast job uploads each chunk once, fans out
    at the relays of its distribution trees, and completes when every
    destination holds every chunk."""

    plan: TransferPlan | MulticastPlan
    name: str = ""
    arrival_s: float = 0.0
    chunk_mb: float = 16.0


@dataclasses.dataclass(frozen=True)
class LinkDegrade:
    """At ``t_s``, the (src, dst) region-pair link drops to ``factor`` of its
    current capacity (per-connection rates and the shared link cap)."""

    t_s: float
    src: int  # region index
    dst: int
    factor: float


@dataclasses.dataclass(frozen=True)
class GrayFailure:
    """At ``t_s``, the (src, dst) link silently delivers ``factor`` of its
    current rate. Data-plane effect identical to ``LinkDegrade``; control-
    plane effect deliberately absent — there is NO failure signal, so the
    orchestrator keeps planning on the healthy view until telemetry or a
    breaker notices the shortfall. A silent recovery is another
    ``GrayFailure`` carrying the inverse factor."""

    t_s: float
    src: int  # region index
    dst: int
    factor: float


@dataclasses.dataclass(frozen=True)
class LinkRestore:
    """At ``t_s``, the (src, dst) link recovers: rates multiply by
    ``factor`` (the inverse of an earlier degrade, > 1). Visible to the
    service — the degraded-topology view heals (capped at full capacity)
    and circuit breakers read it as the up-edge of a flap."""

    t_s: float
    src: int  # region index
    dst: int
    factor: float


# Every event that is a pure rate multiplication on one directed link.
# BOTH event loops must dispatch on this tuple (not on LinkDegrade alone):
# a rate event handled by one simulator and not the other breaks the
# chunk-for-chunk parity the chaos tests pin.
RATE_EVENTS = (LinkDegrade, GrayFailure, LinkRestore)


@dataclasses.dataclass(frozen=True)
class VMFailure:
    """At ``t_s``, ``count`` gateway VMs of job ``job`` in ``region`` die.

    Connections touching a dead VM are gone for good; chunks they carried
    return to their stage's ready queue and retry on surviving workers."""

    t_s: float
    job: int  # index into the job list
    region: int  # region index
    count: int = 1


@dataclasses.dataclass
class JobSimResult:
    """Per-job outcome of a multi-job simulation."""

    job: int
    name: str
    time_s: float  # arrival -> completion (or horizon / stall point)
    tput_gbps: float
    chunks_delivered: int  # multicast: chunks EVERY destination holds
    n_chunks: int
    retried_chunks: int
    egress_cost: float
    vm_cost: float
    total_cost: float
    status: str  # "done" | "running" | "stalled" | "pending"
    per_edge_gb: dict
    # multicast only: destination region -> chunks delivered there
    per_dst_delivered: dict | None = None
    # passive-telemetry support (vectorized sim only): "a->b" -> seconds the
    # job had at least one active connection on that edge, and the GB moved
    # within that window. Both stop where a drain begins (the observation
    # window is the horizon interval; the straggler tail would dilute the
    # rate). Observed-GB over active-seconds is the link rate the
    # calibration plane feeds back into its belief — bytes/duration would
    # under-read links that idled while the job waited on other hops.
    per_edge_active_s: dict | None = None
    per_edge_obs_gb: dict | None = None
    # connections still carrying a partially-transferred chunk when the sim
    # ended (0 for completed jobs). A horizon cut restarts these chunks from
    # scratch in the next segment — the service counts them against the
    # job's retry budget, same as a gateway re-dispatching a chunk whose
    # worker died mid-copy.
    chunks_in_flight: int = 0

    @property
    def done(self) -> bool:
        return self.status == "done"

    @property
    def remaining_chunks(self) -> int:
        return self.n_chunks - self.chunks_delivered


@dataclasses.dataclass
class MultiSimResult:
    jobs: list[JobSimResult]
    time_s: float
    events: int  # event-loop iterations (perf accounting)

    @property
    def all_done(self) -> bool:
        return all(j.done for j in self.jobs)

    @property
    def total_cost(self) -> float:
        return sum(j.total_cost for j in self.jobs)


@dataclasses.dataclass
class MultiSetup:
    """Everything both event loops need, materialized once per scenario.

    Connections are globally indexed in ascending (job, path/tree, hop/edge,
    conn) order; stages in ascending (job, path/tree, hop/edge) order — the
    dispatch order both simulators iterate in, which is what makes them
    comparable.

    A unicast job's stages form a chain (each stage has at most one child);
    a multicast job's stages are the edges of its distribution trees — a
    stage can have several children (fan-out at a relay) and can both
    deliver (its head region is a destination) and forward on. Completion
    is tracked per (job, destination) "slot": a unicast job has one slot,
    a multicast job one per destination its trees serve."""

    top: object  # Topology of jobs[0] (shared link grid / prices)
    arrivals: np.ndarray  # [J]
    # job indices sorted by (arrival_s, job id). Padded-array engines lay
    # jobs out in THIS order, so it must be deterministic under tied
    # arrivals: a bare ``np.argsort(arrivals)`` (introsort) may permute
    # equal keys differently across runs/platforms, silently reshuffling
    # the padded layout between engines. The job id in the sort key pins
    # the tie-break.
    arrival_order: np.ndarray  # [J]
    n_chunks: np.ndarray  # [J] chunks per job
    chunk_gbit: np.ndarray  # [J] chunk size per job (Gbit)
    chunk_path: list[np.ndarray]  # per job: chunk id -> path/tree id
    vm_eg_cap: np.ndarray  # [NV] per-VM egress cap
    vm_in_cap: np.ndarray
    vm_region: np.ndarray  # [NV]
    vm_job: np.ndarray  # [NV]
    n_stages: int
    stage_job: np.ndarray  # [NS]
    stage_hop: np.ndarray  # [NS] 0 at source-egress stages
    stage_children: list[list[int]]  # [NS] downstream stage ids (fan-out)
    stage_deliver: np.ndarray  # [NS] completion slot fed here, -1 if none
    first_stage: list[list[list[int]]]  # per job: path/tree -> root stages
    slot_job: np.ndarray  # [NSLOT]
    slot_dst: np.ndarray  # [NSLOT] destination region (unicast: plan.dst)
    job_slots: list[list[int]]  # per job: its slot ids
    conn_job: np.ndarray  # [NC] all ascending (job, path, hop, conn)
    conn_sid: np.ndarray
    conn_src: np.ndarray  # global VM ids
    conn_dst: np.ndarray
    conn_rate: np.ndarray  # nominal * straggler multiplier
    conn_edge: np.ndarray  # [NC] index into edges_used
    edges_used: list[tuple[int, int]]
    max_hops: int


def materialize_jobs(
    jobs: list[TransferJob],
    *,
    seed: int = 0,
    straggler_prob: float = 0.05,
    straggler_speed: tuple[float, float] = (0.15, 0.5),
    exec_top=None,
) -> MultiSetup:
    """Materialize VMs, connections and chunk streams for every job.

    Per-job state is drawn from an independent RNG stream seeded by
    (seed, job index) in the same draw order as the single-job simulator:
    one multiplier per connection in connection order, then the chunk->path
    assignment.

    ``exec_top`` executes the jobs against a different throughput grid
    than the one they were planned on (same regions; built with
    ``Topology.with_tput``): connection rates and shared link capacities
    come from ``exec_top``, while each plan's F/N/M allocations stand.
    This is the calibration plane's split view — plans are made on the
    BELIEVED grid, the data plane delivers the TRUE one, and the gap is
    what passive telemetry observes. RNG draws are identical either way,
    so a believed-vs-true pair of runs differs only in rates."""
    if not jobs:
        raise ValueError("no jobs")
    top0 = jobs[0].plan.top
    for job in jobs:
        top = job.plan.top
        if top is not top0 and not (
            top.num_regions == top0.num_regions
            and np.array_equal(top.tput, top0.tput)
            and np.array_equal(top.price_egress, top0.price_egress)
        ):
            raise ValueError(
                "all jobs must share one topology (shared link caps and "
                "egress prices come from the first job's grid)"
            )
    if exec_top is not None:
        if exec_top.num_regions != top0.num_regions:
            raise ValueError(
                "exec_top must cover the same regions as the job plans"
            )
        if exec_top.limit_conn != top0.limit_conn:
            raise ValueError("exec_top must keep the planned limit_conn")

    arrivals = np.array([float(j.arrival_s) for j in jobs])
    n_chunks = np.zeros(len(jobs), dtype=np.int64)
    chunk_gbit = np.zeros(len(jobs))
    chunk_path: list[np.ndarray] = []

    vm_eg_cap: list[float] = []
    vm_in_cap: list[float] = []
    vm_region: list[int] = []
    vm_job: list[int] = []

    stage_job: list[int] = []
    stage_hop: list[int] = []
    stage_children: list[list[int]] = []
    stage_deliver: list[int] = []
    first_stage: list[list[list[int]]] = []
    slot_job: list[int] = []
    slot_dst: list[int] = []
    job_slots: list[list[int]] = []

    conn_job: list[int] = []
    conn_sid: list[int] = []
    conn_src: list[int] = []
    conn_dst: list[int] = []
    conn_rate: list[float] = []
    conn_edge_pairs: list[tuple[int, int]] = []
    max_hops = 1

    def add_conns(j, top, rng, sid, a, b, n_conn, vms_a, vms_b):
        per_pair = max(n_conn / (len(vms_a) * len(vms_b)), 1e-9)
        eff = conn_efficiency(per_pair * len(vms_b), top.limit_conn)
        nominal = top.tput[a, b] * eff / n_conn * len(vms_a)
        for c in range(n_conn):
            if rng.uniform() < straggler_prob:
                mult = float(rng.uniform(*straggler_speed))
            else:
                mult = float(np.exp(rng.normal(0.0, 0.05)))
            conn_job.append(j)
            conn_sid.append(sid)
            conn_src.append(vms_a[c % len(vms_a)])
            conn_dst.append(vms_b[c % len(vms_b)])
            conn_rate.append(nominal * mult)
            conn_edge_pairs.append((a, b))

    for j, job in enumerate(jobs):
        plan = job.plan
        top = plan.top
        # connection rates come from the EXECUTION grid (true topology when
        # the calibration plane splits the view); allocations from the plan
        gtop = exec_top if exec_top is not None else top
        rng = np.random.default_rng([seed, j])
        multicast = isinstance(plan, MulticastPlan)

        volume_gbit = plan.volume_gb * GBIT_PER_GB
        cg = job.chunk_mb * 8.0 / 1024.0
        chunk_gbit[j] = cg
        n_chunks[j] = max(1, int(np.ceil(volume_gbit / cg)))

        # ---- VMs (global ids, appended in job then region order)
        vm_of: dict[int, list[int]] = {}
        for r in range(top.num_regions):
            ids = []
            for _ in range(int(round(plan.N[r]))):
                ids.append(len(vm_eg_cap))
                vm_eg_cap.append(top.limit_egress[r])
                vm_in_cap.append(top.limit_ingress[r])
                vm_region.append(r)
                vm_job.append(j)
            vm_of[r] = ids

        if not multicast:
            paths = plan.paths()
            if not paths:
                raise ValueError(f"job {j} ({job.name!r}) carries no flow")
            slot0 = len(slot_job)
            slot_job.append(j)
            slot_dst.append(plan.dst)
            job_slots.append([slot0])

            # ---- stages: one per (path, hop), chained
            stage_of: dict[tuple[int, int], int] = {}
            path_len = {pid: len(p) - 1 for pid, (p, _) in enumerate(paths)}
            max_hops = max(max_hops, max(path_len.values()))
            for pid, (path, _) in enumerate(paths):
                for hop in range(path_len[pid]):
                    stage_of[(pid, hop)] = len(stage_job)
                    stage_job.append(j)
                    stage_hop.append(hop)
                    stage_children.append([])
                    stage_deliver.append(-1)
            for (pid, hop), sid in stage_of.items():
                if hop + 1 < path_len[pid]:
                    stage_children[sid] = [stage_of[(pid, hop + 1)]]
                else:
                    stage_deliver[sid] = slot0
            first_stage.append(
                [[stage_of[(pid, 0)]] for pid in range(len(paths))]
            )

            # ---- connections: same nominal-rate formula as the 1-job sim
            edge_flow_total: dict[tuple[int, int], float] = {}
            for path, flow in paths:
                for a, b in zip(path[:-1], path[1:]):
                    edge_flow_total[(a, b)] = (
                        edge_flow_total.get((a, b), 0.0) + flow
                    )
            for pid, (path, flow) in enumerate(paths):
                for hop, (a, b) in enumerate(zip(path[:-1], path[1:])):
                    m_edge = int(round(plan.M[a, b]))
                    share = flow / edge_flow_total[(a, b)]
                    n_conn = max(1, int(round(m_edge * share)))
                    vms_a = vm_of.get(a) or []
                    vms_b = vm_of.get(b) or []
                    if not vms_a or not vms_b:
                        raise ValueError(
                            f"job {j} has flow on edge {a}->{b} but no VMs"
                        )
                    add_conns(j, gtop, rng, stage_of[(pid, hop)], a, b,
                              n_conn, vms_a, vms_b)

            flows = np.array([f for _, f in paths])
            chunk_path.append(
                rng.choice(len(paths), size=int(n_chunks[j]),
                           p=flows / flows.sum())
            )
            continue

        # -------------------------------------------------- multicast job
        trees = plan.trees()
        if not trees:
            raise ValueError(f"job {j} ({job.name!r}) carries no flow")
        served = sorted({d for t in trees for d in t.paths})
        slot_of = {}
        slots_j = []
        for d in served:
            slot_of[d] = len(slot_job)
            slots_j.append(len(slot_job))
            slot_job.append(j)
            slot_dst.append(d)
        job_slots.append(slots_j)

        # ---- stages: one per (tree, edge), children = tree fan-out
        stage_of_edge: list[dict[tuple[int, int], int]] = []
        firsts_j: list[list[int]] = []
        for t in trees:
            edges = t.edges()
            max_hops = max(max_hops, len(edges))
            hop_of: dict[tuple[int, int], int] = {}
            for p in t.paths.values():
                for i, e in enumerate(zip(p[:-1], p[1:])):
                    hop_of[e] = min(hop_of.get(e, i), i)
            s_of: dict[tuple[int, int], int] = {}
            for e in edges:
                s_of[e] = len(stage_job)
                stage_job.append(j)
                stage_hop.append(hop_of[e])
                stage_children.append([])
                stage_deliver.append(-1)
            children = t.children()
            delivers = t.delivers()
            for e in edges:
                stage_children[s_of[e]] = [s_of[c] for c in children[e]]
            for e, d in delivers.items():
                stage_deliver[s_of[e]] = slot_of[d]
            stage_of_edge.append(s_of)
            firsts_j.append([s_of[e] for e in t.roots()])
        first_stage.append(firsts_j)

        # ---- connections: the envelope usage of an edge is shared by the
        # trees riding it, so each tree gets its rate share of M_e
        edge_rate_total: dict[tuple[int, int], float] = {}
        for t in trees:
            for e in t.edges():
                edge_rate_total[e] = edge_rate_total.get(e, 0.0) + t.rate
        for tid, t in enumerate(trees):
            for e in t.edges():
                a, b = e
                m_edge = int(round(plan.M[a, b]))
                share = t.rate / edge_rate_total[e]
                n_conn = max(1, int(round(m_edge * share)))
                vms_a = vm_of.get(a) or []
                vms_b = vm_of.get(b) or []
                if not vms_a or not vms_b:
                    raise ValueError(
                        f"job {j} has flow on edge {a}->{b} but no VMs"
                    )
                add_conns(j, gtop, rng, stage_of_edge[tid][e], a, b,
                          n_conn, vms_a, vms_b)

        rates = np.array([t.rate for t in trees])
        chunk_path.append(
            rng.choice(len(trees), size=int(n_chunks[j]),
                       p=rates / rates.sum())
        )

    edges_used = sorted(set(conn_edge_pairs))
    edge_index = {e: i for i, e in enumerate(edges_used)}
    return MultiSetup(
        top=exec_top if exec_top is not None else top0,
        arrivals=arrivals,
        arrival_order=np.asarray(
            sorted(range(len(jobs)), key=lambda j: (float(arrivals[j]), j)),
            dtype=np.int64,
        ),
        n_chunks=n_chunks,
        chunk_gbit=chunk_gbit,
        chunk_path=chunk_path,
        vm_eg_cap=np.asarray(vm_eg_cap, dtype=float),
        vm_in_cap=np.asarray(vm_in_cap, dtype=float),
        vm_region=np.asarray(vm_region, dtype=np.int64),
        vm_job=np.asarray(vm_job, dtype=np.int64),
        n_stages=len(stage_job),
        stage_job=np.asarray(stage_job, dtype=np.int64),
        stage_hop=np.asarray(stage_hop, dtype=np.int64),
        stage_children=stage_children,
        stage_deliver=np.asarray(stage_deliver, dtype=np.int64),
        first_stage=first_stage,
        slot_job=np.asarray(slot_job, dtype=np.int64),
        slot_dst=np.asarray(slot_dst, dtype=np.int64),
        job_slots=job_slots,
        conn_job=np.asarray(conn_job, dtype=np.int64),
        conn_sid=np.asarray(conn_sid, dtype=np.int64),
        conn_src=np.asarray(conn_src, dtype=np.int64),
        conn_dst=np.asarray(conn_dst, dtype=np.int64),
        conn_rate=np.asarray(conn_rate, dtype=float),
        conn_edge=np.asarray(
            [edge_index[e] for e in conn_edge_pairs], dtype=np.int64
        ),
        edges_used=edges_used,
        max_hops=max_hops,
    )


def sorted_schedule(
    jobs: list[TransferJob], faults
) -> list[tuple[float, int, object]]:
    """Arrivals + faults merged into one (time, seq, payload) list. Payloads:
    an int job index for arrivals, or the fault event itself."""
    sched: list[tuple[float, int, object]] = []
    for j, job in enumerate(jobs):
        sched.append((float(job.arrival_s), len(sched), j))
    for f in faults:
        sched.append((float(f.t_s), len(sched), f))
    sched.sort(key=lambda e: (e[0], e[1]))
    return sched
