# Frozen copy of src/repro/transfer/flowsim.py at commit 9de379d4b486;
# only the imports changed.
"""Fluid (max-min fair) simulator of Skyplane's data plane.

Executes a ``TransferPlan`` at chunk granularity over the planned gateway
VMs and TCP connections:

  * per-connection nominal rate from the throughput grid at 64 connections,
    with the paper's sub-linear connection-scaling curve (Fig. 9a);
  * per-VM egress/ingress caps shared max-min fairly (water-filling) among
    the connections using that VM;
  * straggler connections (random slow multipliers) — mitigated by dynamic
    chunk dispatch (paper §6) vs. exposed by GridFTP-style static
    round-robin assignment;
  * hop-by-hop flow control: a relay whose chunk buffer is full stalls its
    incoming connections (paper §6);
  * store-and-forward per chunk at relays, pipelined across chunks.

Outputs transfer time, achieved throughput, realized egress/VM cost and
per-resource utilization for the bottleneck analysis (Fig. 8).

The event loop is vectorized (structure-of-arrays connection state, deque
chunk queues, bincount byte accounting, and max-min rates recomputed only
when the set of active connections changes), running ~an order of magnitude
more events/s than the object-per-connection reference preserved in
``flowsim_ref.py`` — enough to push Fig. 6/7/8 workloads to 10x the chunk
counts. Semantics match the reference (same RNG stream, same dispatch and
speculation rules); tests pin delivered-chunk counts to it at fixed seed.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from ..core.plan import MulticastPlan, TransferPlan
from ..core.topology import GBIT_PER_GB
from ..obs.trace import get_tracer

from .simconfig import SimConfig
from .simconfig import resolve as resolve_sim_config
from .simconfig import warn_deprecated_entry as _warn_deprecated_entry

_EPS = 1e-12


def conn_efficiency(n: int, limit: int = 64) -> float:
    """Aggregate throughput fraction of the grid value achieved with n
    connections per VM pair (paper Fig. 9a: sub-linear, ~plateau at 64)."""
    if n <= 0:
        return 0.0
    return min(1.0, (n / limit) ** 0.9)


@dataclasses.dataclass
class SimResult:
    time_s: float
    tput_gbps: float
    egress_cost: float
    vm_cost: float
    total_cost: float
    chunks_delivered: int
    per_edge_gb: dict
    utilization: dict  # resource name -> fraction of capacity used
    bottlenecks: list  # resources with utilization >= threshold
    volume_gb: float = 0.0
    events: int = 0  # simulator event-loop iterations (perf accounting)

    @property
    def cost_per_gb(self) -> float:
        return self.total_cost / max(self.volume_gb, 1e-9)


def _maxmin_rates_arr(caps, src, dst, vm_eg_cap, vm_in_cap,
                      eid=None, edge_cap=None):
    """Water-filling max-min fair allocation over the active connections.

    caps/src/dst are aligned arrays for the active set; returns the rate
    array in the same order. Resources: each connection's own cap, each VM's
    egress cap over its outgoing conns, each VM's ingress cap over incoming,
    and — when ``eid``/``edge_cap`` are given (multi-job mode) — each shared
    wide-area link's capacity over every tenant's connections on it.
    """
    n = caps.shape[0]
    nv = max(int(src.max()), int(dst.max())) + 1
    eg_rem = vm_eg_cap[:nv].copy()
    in_rem = vm_in_cap[:nv].copy()
    ne = 0
    if eid is not None:
        ne = edge_cap.shape[0]
        ed_rem = edge_cap.copy()

    rate = np.zeros(n)
    fixed = np.zeros(n, dtype=bool)
    for _ in range(2 * nv + ne + 4):
        un = ~fixed
        if not un.any():
            break
        cnt_out = np.bincount(src[un], minlength=nv).astype(float)
        cnt_in = np.bincount(dst[un], minlength=nv).astype(float)
        with np.errstate(divide="ignore", invalid="ignore"):
            share_out = np.where(cnt_out > 0, eg_rem / np.maximum(cnt_out, 1), np.inf)
            share_in = np.where(cnt_in > 0, in_rem / np.maximum(cnt_in, 1), np.inf)
        share = np.minimum(share_out[src], share_in[dst])
        if ne:
            cnt_ed = np.bincount(eid[un], minlength=ne).astype(float)
            with np.errstate(divide="ignore", invalid="ignore"):
                share_ed = np.where(
                    cnt_ed > 0, ed_rem / np.maximum(cnt_ed, 1), np.inf
                )
            share = np.minimum(share, share_ed[eid])
        newly = un & (caps <= share + _EPS)
        if newly.any():
            rate[newly] = caps[newly]
        else:
            thresh = share[un].min()
            newly = un & (share <= thresh + _EPS)
            rate[newly] = share[newly]
        eg_rem -= np.bincount(src[newly], weights=rate[newly], minlength=nv)
        in_rem -= np.bincount(dst[newly], weights=rate[newly], minlength=nv)
        np.maximum(eg_rem, 0.0, out=eg_rem)
        np.maximum(in_rem, 0.0, out=in_rem)
        if ne:
            ed_rem -= np.bincount(eid[newly], weights=rate[newly], minlength=ne)
            np.maximum(ed_rem, 0.0, out=ed_rem)
        fixed |= newly
    return rate


def simulate_transfer(
    plan: TransferPlan,
    *,
    chunk_mb: float = 16.0,
    dispatch: str = "dynamic",  # "dynamic" (Skyplane) | "static" (GridFTP)
    straggler_prob: float = 0.05,
    straggler_speed: tuple[float, float] = (0.15, 0.5),
    relay_buffer_chunks: int = 64,
    seed: int = 0,
    util_threshold: float = 0.99,
    speculative: bool | None = None,  # re-dispatch straggling chunks (tail
    # kill). Defaults to True for dynamic dispatch — the natural extension of
    # paper §6's ready-connection dispatch; duplicate bytes are billed.
) -> SimResult:
    if speculative is None:
        speculative = dispatch == "dynamic"
    top = plan.top
    rng = np.random.default_rng(seed)
    paths = plan.paths()
    if not paths:
        raise ValueError("plan carries no flow")

    volume_gbit = plan.volume_gb * GBIT_PER_GB
    chunk_gbit = chunk_mb * 8.0 / 1024.0
    n_chunks = max(1, int(np.ceil(volume_gbit / chunk_gbit)))

    # ---- materialize VMs
    vm_of_region: dict[int, list[int]] = {}
    vm_eg_cap: list[float] = []
    vm_in_cap: list[float] = []
    vm_region: list[int] = []
    for r in range(top.num_regions):
        cnt = int(round(plan.N[r]))
        ids = []
        for _ in range(cnt):
            ids.append(len(vm_eg_cap))
            vm_eg_cap.append(top.limit_egress[r])
            vm_in_cap.append(top.limit_ingress[r])
            vm_region.append(r)
        vm_of_region[r] = ids

    # ---- materialize connections (SoA), same RNG stream as the reference
    path_len = {pid: len(path) - 1 for pid, (path, _) in enumerate(paths)}
    edge_flow_total: dict[tuple[int, int], float] = {}
    for path, flow in paths:
        for a, b in zip(path[:-1], path[1:]):
            edge_flow_total[(a, b)] = edge_flow_total.get((a, b), 0.0) + flow

    # stages: one per (path, hop), ids assigned in path/hop order
    stage_of: dict[tuple[int, int], int] = {}
    for pid, (path, _) in enumerate(paths):
        for hop in range(path_len[pid]):
            stage_of[(pid, hop)] = len(stage_of)
    n_stages = len(stage_of)

    c_edge: list[tuple[int, int]] = []
    c_sid: list[int] = []
    c_rate: list[float] = []
    c_src: list[int] = []
    c_dst: list[int] = []
    for pid, (path, flow) in enumerate(paths):
        for hop, (a, b) in enumerate(zip(path[:-1], path[1:])):
            m_edge = int(round(plan.M[a, b]))
            share = flow / edge_flow_total[(a, b)]
            n_conn = max(1, int(round(m_edge * share)))
            vms_a = vm_of_region.get(a) or []
            vms_b = vm_of_region.get(b) or []
            if not vms_a or not vms_b:
                raise ValueError(f"plan has flow on edge {a}->{b} but no VMs")
            per_pair = max(n_conn / (len(vms_a) * len(vms_b)), 1e-9)
            eff = conn_efficiency(per_pair * len(vms_b), top.limit_conn)
            nominal = top.tput[a, b] * eff / n_conn * len(vms_a)
            sid = stage_of[(pid, hop)]
            for c in range(n_conn):
                if rng.uniform() < straggler_prob:
                    mult = float(rng.uniform(*straggler_speed))
                else:
                    mult = float(np.exp(rng.normal(0.0, 0.05)))
                c_edge.append((a, b))
                c_sid.append(sid)
                c_rate.append(nominal * mult)
                c_src.append(vms_a[c % len(vms_a)])
                c_dst.append(vms_b[c % len(vms_b)])

    nc = len(c_sid)
    sid_arr = np.asarray(c_sid, dtype=np.int64)
    rate_eff = np.asarray(c_rate)
    src_vm = np.asarray(c_src, dtype=np.int64)
    dst_vm = np.asarray(c_dst, dtype=np.int64)
    edges_used = sorted(set(c_edge))
    edge_index = {e: i for i, e in enumerate(edges_used)}
    edge_id = np.asarray([edge_index[e] for e in c_edge], dtype=np.int64)
    vm_eg = np.asarray(vm_eg_cap, dtype=float)
    vm_in = np.asarray(vm_in_cap, dtype=float)

    # per-stage metadata
    stage_pid = np.zeros(n_stages, dtype=np.int64)
    stage_hop = np.zeros(n_stages, dtype=np.int64)
    stage_next = np.full(n_stages, -1, dtype=np.int64)  # downstream stage id
    for (pid, hop), sid in stage_of.items():
        stage_pid[sid] = pid
        stage_hop[sid] = hop
        if hop + 1 < path_len[pid]:
            stage_next[sid] = stage_of[(pid, hop + 1)]
    next_sid = stage_next[sid_arr]  # -1 when this hop is the last

    chunk_arr = np.full(nc, -1, dtype=np.int64)
    remaining = np.zeros(nc)

    flows = np.array([f for _, f in paths])
    flow_frac = flows / flows.sum()

    # chunk -> path assignment: proportional to planned flow (both modes)
    chunk_path = rng.choice(len(paths), size=n_chunks, p=flow_frac)
    ready: list[deque] = [deque() for _ in range(n_stages)]
    for ch in range(n_chunks):
        ready[stage_of[(int(chunk_path[ch]), 0)]].append(ch)
    # static (GridFTP) mode: pre-assign chunks round-robin to connections
    static_assign: dict[int, deque] = {}
    if dispatch == "static":
        by_first_hop: dict[int, list[int]] = {}
        for ci in range(nc):
            if stage_hop[sid_arr[ci]] == 0:
                by_first_hop.setdefault(int(stage_pid[sid_arr[ci]]), []).append(ci)
        rrobin: dict[int, int] = {}
        for ch in range(n_chunks):
            pid = int(chunk_path[ch])
            lst = by_first_hop[pid]
            k = rrobin.get(pid, 0)
            static_assign.setdefault(lst[k % len(lst)], deque()).append(ch)
            rrobin[pid] = k + 1
    # every first-hop connection is statically routed in static mode — even
    # ones that received no chunks (they must NOT fall through to the shared
    # ready queue, mirroring the reference semantics)
    is_static_first = np.zeros(nc, dtype=bool)
    if dispatch == "static":
        is_static_first = stage_hop[sid_arr] == 0

    relay_occ = np.zeros(n_stages, dtype=np.int64)  # buffered chunks per stage
    done_hops: set[tuple[int, int]] = set()  # (sid, chunk)
    replicas: dict[tuple[int, int], int] = {}  # (sid, chunk) -> replica count
    delivered = 0
    now = 0.0
    edge_gbit_vec = np.zeros(len(edges_used))
    vm_busy_out = np.zeros(len(vm_eg_cap))
    vm_busy_in = np.zeros(len(vm_eg_cap))

    # per-cascade-pass cache: sid -> (eta, chunk) of the worst eligible
    # in-flight chunk, or None; invalidated when the stage's state changes
    spec_cache: dict[int, tuple[float, int] | None] = {}

    def _stage_worst(sid: int):
        cand = np.flatnonzero((sid_arr == sid) & (chunk_arr >= 0))
        if cand.size == 0:
            return None
        etas = remaining[cand] / np.maximum(rate_eff[cand], _EPS)
        for j in np.argsort(-etas):
            ch = int(chunk_arr[cand[j]])
            if replicas.get((sid, ch), 1) < 2:
                return float(etas[j]), ch
        return None

    def try_speculate(ci: int) -> bool:
        """Idle conn + empty queue: duplicate the worst-ETA in-flight chunk
        on this stage; first finisher wins, loser's bytes are billed."""
        sid = int(sid_arr[ci])
        if sid in spec_cache:
            worst = spec_cache[sid]
        else:
            worst = _stage_worst(sid)
            spec_cache[sid] = worst
        if worst is None:
            return False
        eta, ch = worst
        if eta < 2.0 * (chunk_gbit / max(rate_eff[ci], _EPS)):
            return False
        replicas[(sid, ch)] = replicas.get((sid, ch), 1) + 1
        chunk_arr[ci] = ch
        remaining[ci] = chunk_gbit
        spec_cache.pop(sid, None)
        return True

    def try_refill(ci: int) -> bool:
        sid = sid_arr[ci]
        nsid = next_sid[ci]
        # flow control: downstream relay buffer full -> stall
        if nsid >= 0 and relay_occ[nsid] >= relay_buffer_chunks:
            return False
        if is_static_first[ci]:
            q = static_assign.get(ci)
            if not q:
                return False
        else:
            q = ready[sid]
            if not q:
                if speculative and not (dispatch == "static" and stage_hop[sid] == 0):
                    return try_speculate(ci)
                return False
        ch = q.popleft()
        chunk_arr[ci] = ch
        remaining[ci] = chunk_gbit
        if stage_hop[sid] > 0:
            relay_occ[sid] -= 1
        spec_cache.pop(int(sid), None)  # stage gained an in-flight chunk
        return True

    max_events = n_chunks * 6 * max(path_len.values()) + 10000
    events = 0
    last_active = None
    rates = None
    for _ in range(max_events):
        # cascade refills (buffer drains unlock upstream); candidate filter
        # keeps each pass O(conns with plausibly available work)
        while True:
            progressed = False
            spec_cache.clear()
            idle = chunk_arr < 0
            if not idle.any():
                break
            queue_work = np.fromiter(
                (len(q) > 0 for q in ready), dtype=bool, count=n_stages
            )[sid_arr]
            cand_mask = idle & queue_work
            if dispatch == "static":
                static_work = np.zeros(nc, dtype=bool)
                for ci, q in static_assign.items():
                    if q:
                        static_work[ci] = True
                cand_mask = (idle & static_work) | (cand_mask & ~is_static_first)
            if speculative:
                inflight = np.bincount(
                    sid_arr[chunk_arr >= 0], minlength=n_stages
                ) > 0
                spec_mask = idle & inflight[sid_arr] & ~queue_work
                if dispatch == "static":
                    spec_mask &= ~is_static_first
                cand_mask |= spec_mask
            for ci in np.flatnonzero(cand_mask):
                if chunk_arr[ci] < 0 and try_refill(ci):
                    progressed = True
            if not progressed:
                break
        active_ix = np.flatnonzero(chunk_arr >= 0)
        if active_ix.size == 0:
            break
        events += 1
        # max-min rates depend only on the active membership: reuse if same
        if last_active is None or not np.array_equal(active_ix, last_active):
            rates = _maxmin_rates_arr(
                rate_eff[active_ix], src_vm[active_ix], dst_vm[active_ix],
                vm_eg, vm_in,
            )
            last_active = active_ix
        safe_rates = np.maximum(rates, _EPS)
        dt = max(float((remaining[active_ix] / safe_rates).min()), 1e-9)
        now += dt
        moved = rates * dt
        remaining[active_ix] -= moved
        edge_gbit_vec += np.bincount(
            edge_id[active_ix], weights=moved, minlength=len(edges_used)
        )
        vm_busy_out += np.bincount(
            src_vm[active_ix], weights=moved, minlength=vm_busy_out.shape[0]
        )
        vm_busy_in += np.bincount(
            dst_vm[active_ix], weights=moved, minlength=vm_busy_in.shape[0]
        )
        completed = active_ix[remaining[active_ix] <= 1e-9]
        for ci in completed:
            ch = int(chunk_arr[ci])
            if ch < 0:
                continue  # cancelled earlier in this event by a replica win
            sid = int(sid_arr[ci])
            chunk_arr[ci] = -1
            remaining[ci] = 0.0
            key = (sid, ch)
            if key in done_hops:
                continue  # a replica already finished this hop
            done_hops.add(key)
            if replicas.get(key, 1) > 1:
                losers = np.flatnonzero((sid_arr == sid) & (chunk_arr == ch))
                chunk_arr[losers] = -1
                remaining[losers] = 0.0
            nsid = int(stage_next[sid])
            if nsid >= 0:
                ready[nsid].append(ch)
                relay_occ[nsid] += 1
            else:
                delivered += 1
        if delivered >= n_chunks:
            break

    time_s = max(now, 1e-9)
    tput = delivered * chunk_gbit / time_s
    per_edge_gb = {e: edge_gbit_vec[i] / GBIT_PER_GB
                   for e, i in edge_index.items() if edge_gbit_vec[i] > 0}
    egress_cost = sum(
        gb * top.price_egress[e] for e, gb in per_edge_gb.items()
    )
    vm_cost = float(plan.N @ top.price_vm) * time_s

    # ---- utilization / bottleneck attribution (Fig. 8)
    src_r, dst_r = plan.src, plan.dst
    util: dict[str, float] = {}
    for v in range(len(vm_eg_cap)):
        r = vm_region[v]
        loc = ("source_vm" if r == src_r else
               "dest_vm" if r == dst_r else "overlay_vm")
        used = max(vm_busy_out[v], vm_busy_in[v])
        cap = (vm_eg_cap[v] if vm_busy_out[v] >= vm_busy_in[v] else vm_in_cap[v])
        u = used / max(cap * time_s, _EPS)
        util[loc] = max(util.get(loc, 0.0), u)
    for (a, b), gb in per_edge_gb.items():
        loc = "source_link" if a == src_r else "overlay_link"
        cap = top.tput[a, b] * max(plan.N[a], 1)
        u = gb * GBIT_PER_GB / max(cap * time_s, _EPS)
        util[loc] = max(util.get(loc, 0.0), u)
    bottlenecks = [k for k, v in util.items() if v >= util_threshold]

    res = SimResult(
        time_s=time_s,
        tput_gbps=tput,
        egress_cost=float(egress_cost),
        vm_cost=float(vm_cost),
        total_cost=float(egress_cost + vm_cost),
        chunks_delivered=delivered,
        per_edge_gb={f"{e[0]}->{e[1]}": gb for e, gb in per_edge_gb.items()},
        utilization=util,
        bottlenecks=bottlenecks,
        volume_gb=plan.volume_gb,
        events=events,
    )
    return res


# --------------------------------------------------------------------- multi
def simulate_multi(
    jobs,
    faults=(),
    *,
    config: SimConfig | None = None,
    link_capacity_scale: float | None = 2.0,
    straggler_prob: float = 0.05,
    straggler_speed: tuple[float, float] = (0.15, 0.5),
    relay_buffer_chunks: int = 64,
    seed: int = 0,
    horizon_s: float | None = None,
    exec_top=None,
    drain: bool = False,
):
    """Deprecated alias for ``transfer.sim.simulate(engine="soa")``.

    Kept (signature-pinned, bitwise-equal) for backward compatibility;
    new code goes through the dispatcher, which is the one place the
    ``engine`` knob is honored. SKY010 bans fresh first-party calls."""
    _warn_deprecated_entry("flowsim.simulate_multi")
    return _simulate_multi_impl(
        jobs, faults, config=config,
        link_capacity_scale=link_capacity_scale,
        straggler_prob=straggler_prob, straggler_speed=straggler_speed,
        relay_buffer_chunks=relay_buffer_chunks, seed=seed,
        horizon_s=horizon_s, exec_top=exec_top, drain=drain,
    )


def _simulate_multi_impl(
    jobs,
    faults=(),
    *,
    config: SimConfig | None = None,
    link_capacity_scale: float | None = 2.0,
    straggler_prob: float = 0.05,
    straggler_speed: tuple[float, float] = (0.15, 0.5),
    relay_buffer_chunks: int = 64,
    seed: int = 0,
    horizon_s: float | None = None,
    exec_top=None,
    drain: bool = False,
):
    """Vectorized multi-job simulator with scripted faults (ISSUE 2/3).

    Runs every ``TransferJob`` concurrently on one fluid data plane:

      * jobs arrive at ``job.arrival_s``; chunks enter their first-hop
        queues on arrival;
      * connections of all tenants share VM caps per job AND the wide-area
        links — each directed region pair is a fluid resource of capacity
        ``link_capacity_scale * top.tput[a, b]`` divided max-min fairly
        (``link_capacity_scale=None`` disables link contention);
      * a job whose plan is a ``MulticastPlan`` uploads each chunk once and
        fans out at relays: a completed hop feeds EVERY child stage of its
        distribution tree (deduplicated — shared segments carry a chunk
        once), deliveries are tracked per destination, and the job is done
        when every destination holds every chunk;
      * ``events.LinkDegrade`` multiplies the affected connections' rates
        and the shared link cap mid-transfer;
      * ``events.VMFailure`` kills gateway VMs: their connections die and
        any chunk they carried re-enters its stage queue and retries on a
        surviving connection of the same branch (counted in
        ``retried_chunks``; a stage whose every connection died stalls the
        job);
      * ``horizon_s`` cuts the run (jobs report status "running"). All
        time comparisons share one tolerance (``events.T_EPS``) so a
        boundary event cannot be classified inconsistently.
        ``drain=True`` makes the cut graceful: past the horizon no new
        chunk is picked up and no further scripted event applies, but
        chunks already on the wire run to completion (``time_s`` may
        exceed the horizon). Periodic re-segmentation (the calibration
        plane's probe cadence) NEEDS this — a hard cut discards every
        in-flight chunk, so a link whose per-chunk ETA exceeds the
        segment length would never complete anything across restarts;
      * ``exec_top`` executes against a different throughput grid than the
        jobs were planned on (the calibration plane's believed/true split
        — see ``events.materialize_jobs``); per-job results then carry
        ``per_edge_active_s`` so observed link rates (GB over busy
        seconds) can feed the belief as passive telemetry.

    Dispatch is the dynamic (paper §6) mode; speculation is off so retry
    accounting stays exact. Returns ``events.MultiSimResult``; the oracle
    is ``flowsim_ref.simulate_multi_reference`` (same per-job chunk counts
    at fixed seed — pinned by tests/test_multijob.py + test_multicast.py).
    """
    from .events import T_EPS, JobSimResult, MultiSimResult
    from .events import materialize_jobs, sorted_schedule

    cfg = resolve_sim_config(
        config, link_capacity_scale=link_capacity_scale,
        straggler_prob=straggler_prob, straggler_speed=straggler_speed,
        relay_buffer_chunks=relay_buffer_chunks, seed=seed,
        horizon_s=horizon_s, exec_top=exec_top, drain=drain,
    )
    link_capacity_scale = cfg.link_capacity_scale
    relay_buffer_chunks = cfg.relay_buffer_chunks
    horizon_s, drain = cfg.horizon_s, cfg.drain
    su = materialize_jobs(
        jobs, seed=cfg.seed, straggler_prob=cfg.straggler_prob,
        straggler_speed=cfg.straggler_speed, exec_top=cfg.exec_top,
    )
    top = su.top
    J = len(jobs)
    nc = su.conn_job.shape[0]
    ne = len(su.edges_used)
    rate_eff = su.conn_rate.copy()
    sid_arr = su.conn_sid
    children = su.stage_children
    edge_cap = None
    if link_capacity_scale is not None:
        edge_cap = np.array(
            [top.tput[a, b] * link_capacity_scale for a, b in su.edges_used]
        )

    conn_alive = np.ones(nc, dtype=bool)
    vm_alive = np.ones(su.vm_eg_cap.shape[0], dtype=bool)
    arrived = np.zeros(J, dtype=bool)
    chunk_arr = np.full(nc, -1, dtype=np.int64)
    remaining = np.zeros(nc)
    chunk_size = su.chunk_gbit[su.conn_job]  # per-conn chunk size (Gbit)
    ready: list[deque] = [deque() for _ in range(su.n_stages)]
    relay_occ = np.zeros(su.n_stages, dtype=np.int64)
    done_hops: set[tuple[int, int]] = set()
    enqueued: set[tuple[int, int]] = set()  # fan-in dedup on propagation
    n_slots = su.slot_job.shape[0]
    delivered = np.zeros(n_slots, dtype=np.int64)
    retried = np.zeros(J, dtype=np.int64)
    finish: list[float | None] = [None] * J
    job_edge_gbit = np.zeros(J * ne)
    # telemetry observation window: bytes and busy-seconds accumulated only
    # BEFORE the drain starts. The drain tail (a handful of straggler
    # connections finishing their last chunk) would otherwise dilute
    # bytes-over-busy-time far below the rate the link actually sustained,
    # and the calibration plane would read healthy links as drifted.
    job_edge_obs_gbit = np.zeros(J * ne)
    job_edge_busy = np.zeros(J * ne)  # obs-window seconds with active conns

    sched = sorted_schedule(jobs, faults)
    ptr = 0
    now = 0.0
    last_active = None
    rates = None
    tr = get_tracer()
    if tr.enabled:
        tr.instant("sim.start", 0.0, jobs=J, scheduled=len(sched))

    def apply_due():
        nonlocal ptr, last_active
        from .events import RATE_EVENTS, VMFailure

        applied_t = None
        rate_n = 0
        while ptr < len(sched) and sched[ptr][0] <= now + T_EPS:
            t_ev = sched[ptr][0]
            ev = sched[ptr][2]
            ptr += 1
            last_active = None  # any event can change rates/membership
            applied_t = t_ev
            if isinstance(ev, int):  # job arrival
                arrived[ev] = True
                firsts = su.first_stage[ev]
                for ch in range(int(su.n_chunks[ev])):
                    for s0 in firsts[int(su.chunk_path[ev][ch])]:
                        ready[s0].append(ch)
                if tr.enabled:
                    tr.instant("sim.arrival", t_ev, job=int(ev),
                               chunks=int(su.n_chunks[ev]))
            elif isinstance(ev, RATE_EVENTS):
                # LinkDegrade / GrayFailure / LinkRestore: one compounding
                # multiply on the link's connection rates and shared cap —
                # gray-vs-visible is a control-plane distinction, the data
                # plane feels them all the same way
                on_edge = np.array(
                    [e == (ev.src, ev.dst) for e in su.edges_used], dtype=bool
                )
                rate_eff[on_edge[su.conn_edge]] *= ev.factor
                if edge_cap is not None:
                    edge_cap[on_edge] *= ev.factor
                # rate events arrive in bursts (gray/flap trains expand to
                # thousands); coalesced per batch below so tracing stays
                # inside the obs/tracing_overhead_ratio gate
                rate_n += 1
            elif isinstance(ev, VMFailure):
                kill = [
                    v for v in np.flatnonzero(
                        (su.vm_job == ev.job) & (su.vm_region == ev.region)
                    )
                    if vm_alive[v]
                ][: ev.count]
                requeued = 0
                if kill:
                    vm_alive[kill] = False
                    hit = conn_alive & (
                        np.isin(su.conn_src, kill)
                        | np.isin(su.conn_dst, kill)
                    )
                    for ci in np.flatnonzero(hit):
                        if chunk_arr[ci] >= 0:
                            sid = int(sid_arr[ci])
                            ready[sid].append(int(chunk_arr[ci]))
                            if su.stage_hop[sid] > 0:
                                relay_occ[sid] += 1
                            retried[su.conn_job[ci]] += 1
                            chunk_arr[ci] = -1
                            remaining[ci] = 0.0
                            requeued += 1
                    conn_alive[hit] = False
                if tr.enabled:
                    tr.instant("sim.vm_failure", t_ev, job=int(ev.job),
                               region=int(ev.region), killed=len(kill),
                               requeued=requeued)
            else:
                raise TypeError(f"unknown event {ev!r}")
        if applied_t is not None and tr.enabled:
            if rate_n:
                tr.instant("sim.rate_events", applied_t, n=rate_n)
            # per-link active-connection sample after every applied batch;
            # ts comes from the schedule (exact), not the float clock
            counts = np.bincount(
                su.conn_edge[chunk_arr >= 0], minlength=ne
            )
            for i, (a, b) in enumerate(su.edges_used):
                if counts[i]:
                    tr.sample(f"link {a}->{b}", applied_t, int(counts[i]))

    def try_refill(ci: int) -> bool:
        sid = int(sid_arr[ci])
        # flow control: ANY full downstream buffer stalls the stage — with
        # fan-out, the slowest branch backpressures the shared segment
        for nsid in children[sid]:
            if relay_occ[nsid] >= relay_buffer_chunks:
                return False
        q = ready[sid]
        if not q:
            return False
        chunk_arr[ci] = q.popleft()
        remaining[ci] = chunk_size[ci]
        if su.stage_hop[sid] > 0:
            relay_occ[sid] -= 1
        return True

    max_events = (
        int((su.n_chunks * 6).sum()) * su.max_hops + 10000 + 8 * len(sched)
    )
    events = 0
    draining = False
    for _ in range(max_events):
        if not draining:
            apply_due()
        if horizon_s is not None and now >= horizon_s - T_EPS:
            if not drain:
                break
            draining = True
        # cascade refills (buffer drains unlock upstream); a draining run
        # picks up nothing new
        while not draining:
            progressed = False
            idle = (chunk_arr < 0) & conn_alive & arrived[su.conn_job]
            if not idle.any():
                break
            queue_work = np.fromiter(
                (len(q) > 0 for q in ready), dtype=bool, count=su.n_stages
            )[sid_arr]
            for ci in np.flatnonzero(idle & queue_work):
                if chunk_arr[ci] < 0 and try_refill(ci):
                    progressed = True
            if not progressed:
                break
        active_ix = np.flatnonzero(chunk_arr >= 0)
        t_next = (
            sched[ptr][0] if ptr < len(sched) and not draining else None
        )
        if active_ix.size == 0:
            if t_next is not None and (
                horizon_s is None or t_next < horizon_s - T_EPS
            ):
                now = t_next
                continue
            break
        events += 1
        if last_active is None or not np.array_equal(active_ix, last_active):
            rates = _maxmin_rates_arr(
                rate_eff[active_ix], su.conn_src[active_ix],
                su.conn_dst[active_ix], su.vm_eg_cap, su.vm_in_cap,
                eid=None if edge_cap is None else su.conn_edge[active_ix],
                edge_cap=edge_cap,
            )
            last_active = active_ix
        if float(rates.max(initial=0.0)) <= 1e-9 and t_next is None:
            break  # all remaining links dead: no progress possible, stall
        safe_rates = np.maximum(rates, _EPS)
        dt = max(float((remaining[active_ix] / safe_rates).min()), 1e-9)
        if t_next is not None and now + dt > t_next:
            dt = t_next - now
        horizon_hit = False
        obs_live = not draining  # telemetry window ends where the drain starts
        if horizon_s is not None and now + dt >= horizon_s - T_EPS:
            if drain:
                draining = True  # past the boundary: in-flight only
            else:
                dt = horizon_s - now
                horizon_hit = True
        now += dt
        moved = rates * dt
        remaining[active_ix] -= moved
        je = su.conn_job[active_ix] * ne + su.conn_edge[active_ix]
        job_edge_gbit += np.bincount(je, weights=moved, minlength=J * ne)
        if obs_live:
            job_edge_obs_gbit += np.bincount(
                je, weights=moved, minlength=J * ne
            )
            job_edge_busy[np.unique(je)] += dt
        completed = active_ix[remaining[active_ix] <= 1e-9]
        for ci in completed:
            ch = int(chunk_arr[ci])
            sid = int(sid_arr[ci])
            chunk_arr[ci] = -1
            remaining[ci] = 0.0
            key = (sid, ch)
            if key in done_hops:
                continue
            done_hops.add(key)
            slot = int(su.stage_deliver[sid])
            if slot >= 0:
                delivered[slot] += 1
                j = int(su.slot_job[slot])
                if delivered[slot] >= su.n_chunks[j] and all(
                    delivered[s] >= su.n_chunks[j] for s in su.job_slots[j]
                ):
                    finish[j] = now
                    if tr.enabled:
                        tr.instant("sim.job_done", now, job=j)
            for nsid in children[sid]:
                if (nsid, ch) in enqueued:
                    continue  # another in-edge already fed this stage
                enqueued.add((nsid, ch))
                ready[nsid].append(ch)
                relay_occ[nsid] += 1
        if horizon_hit:
            break
        if all(f is not None for f in finish):
            break

    horizon_cut = horizon_s is not None and now >= horizon_s - T_EPS
    out = []
    for j, job in enumerate(jobs):
        end = finish[j] if finish[j] is not None else now
        dur = max(end - float(su.arrivals[j]), 1e-9)
        eg = job_edge_gbit[j * ne : (j + 1) * ne]
        ego = job_edge_obs_gbit[j * ne : (j + 1) * ne]
        busy = job_edge_busy[j * ne : (j + 1) * ne]
        per_edge_gb = {
            f"{a}->{b}": eg[i] / GBIT_PER_GB
            for i, (a, b) in enumerate(su.edges_used) if eg[i] > 0
        }
        per_edge_obs_gb = {
            f"{a}->{b}": ego[i] / GBIT_PER_GB
            for i, (a, b) in enumerate(su.edges_used) if busy[i] > 0
        }
        per_edge_active_s = {
            f"{a}->{b}": float(busy[i])
            for i, (a, b) in enumerate(su.edges_used) if busy[i] > 0
        }
        eg_cost = sum(
            eg[i] / GBIT_PER_GB * top.price_egress[a, b]
            for i, (a, b) in enumerate(su.edges_used)
        )
        if finish[j] is not None:
            status = "done"
        elif not arrived[j]:
            status, dur = "pending", 0.0
        elif horizon_cut:
            status = "running"
        else:
            status = "stalled"
        slots = su.job_slots[j]
        full_copies = int(min(delivered[s] for s in slots))
        per_dst = (
            {int(su.slot_dst[s]): int(delivered[s]) for s in slots}
            if isinstance(job.plan, MulticastPlan) else None
        )
        vm_cost = float(job.plan.N @ job.plan.top.price_vm) * dur
        out.append(JobSimResult(
            job=j,
            name=job.name,
            time_s=dur,
            tput_gbps=float(full_copies * su.chunk_gbit[j]) / max(dur, 1e-9),
            chunks_delivered=full_copies,
            n_chunks=int(su.n_chunks[j]),
            retried_chunks=int(retried[j]),
            egress_cost=float(eg_cost),
            vm_cost=vm_cost,
            total_cost=float(eg_cost + vm_cost),
            status=status,
            per_edge_gb=per_edge_gb,
            per_dst_delivered=per_dst,
            per_edge_active_s=per_edge_active_s,
            per_edge_obs_gb=per_edge_obs_gb,
            chunks_in_flight=int(np.count_nonzero(
                (su.conn_job == j) & (chunk_arr >= 0)
            )),
        ))
    if tr.enabled:
        tr.instant("sim.end", now,
                   delivered=sum(int(r.chunks_delivered) for r in out))
    return MultiSimResult(jobs=out, time_s=now, events=events)
