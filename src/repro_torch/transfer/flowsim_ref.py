"""Reference (pre-vectorization) fluid simulator — oracle for flowsim.py.

This is the original object-per-connection event loop: a Python ``_Conn``
dataclass per TCP connection, dict-based max-min rate allocation, and
``list.pop(0)`` chunk queues. ``flowsim.simulate_transfer`` replays the same
semantics on numpy arrays at ~an order of magnitude more events/s; the
equivalence tests in tests/test_flowsim.py pin the two together (identical
delivered-chunk counts at fixed seed), and benchmarks/flowsim_bench.py uses
this module as the speedup baseline.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.plan import TransferPlan
from repro_torch.core.topology import GBIT_PER_GB
from repro_torch.obs.trace import get_tracer

from .flowsim import SimResult, conn_efficiency
from .simconfig import SimConfig
from .simconfig import resolve as resolve_sim_config

_EPS = 1e-12


@dataclasses.dataclass
class _Conn:
    edge: tuple[int, int]
    path_id: int
    hop: int  # hop index within the path
    rate_nominal: float  # Gbit/s when unconstrained
    src_vm: int  # global vm index
    dst_vm: int
    mult: float = 1.0  # straggler multiplier
    chunk: int = -1  # active chunk id (-1 idle)
    remaining: float = 0.0  # Gbit left on the active chunk


def _maxmin_rates(conns, active_ix, vm_eg_cap, vm_in_cap):
    """Water-filling max-min fair allocation (vectorized).

    Resources: each active connection's own cap, each VM's egress cap over
    its outgoing conns, each VM's ingress cap over incoming conns.
    """
    n = len(active_ix)
    if n == 0:
        return {}
    caps = np.array([conns[i].rate_nominal * conns[i].mult for i in active_ix])
    src = np.array([conns[i].src_vm for i in active_ix], dtype=np.int64)
    dst = np.array([conns[i].dst_vm for i in active_ix], dtype=np.int64)
    nv = max(int(src.max()), int(dst.max())) + 1
    eg_rem = np.asarray(vm_eg_cap, dtype=float)[:nv].copy()
    in_rem = np.asarray(vm_in_cap, dtype=float)[:nv].copy()

    rate = np.zeros(n)
    fixed = np.zeros(n, dtype=bool)
    for _ in range(2 * nv + 4):
        un = ~fixed
        if not un.any():
            break
        cnt_out = np.bincount(src[un], minlength=nv).astype(float)
        cnt_in = np.bincount(dst[un], minlength=nv).astype(float)
        with np.errstate(divide="ignore", invalid="ignore"):
            share_out = np.where(cnt_out > 0, eg_rem / np.maximum(cnt_out, 1), np.inf)
            share_in = np.where(cnt_in > 0, in_rem / np.maximum(cnt_in, 1), np.inf)
        share = np.minimum(share_out[src], share_in[dst])
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
        fixed |= newly
    return {active_ix[i]: float(rate[i]) for i in range(n)}


def simulate_transfer_reference(
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

    # ---- materialize connections per path hop, proportional to flow share
    conns: list[_Conn] = []
    edge_flow_total: dict[tuple[int, int], float] = {}
    for path, flow in paths:
        for a, b in zip(path[:-1], path[1:]):
            edge_flow_total[(a, b)] = edge_flow_total.get((a, b), 0.0) + flow
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
            for c in range(n_conn):
                mult = 1.0
                if rng.uniform() < straggler_prob:
                    mult = float(rng.uniform(*straggler_speed))
                else:
                    mult = float(np.exp(rng.normal(0.0, 0.05)))
                conns.append(
                    _Conn(
                        edge=(a, b), path_id=pid, hop=hop,
                        rate_nominal=nominal,
                        src_vm=vms_a[c % len(vms_a)],
                        dst_vm=vms_b[c % len(vms_b)],
                        mult=mult,
                    )
                )

    path_len = {pid: len(path) - 1 for pid, (path, _) in enumerate(paths)}
    flows = np.array([f for _, f in paths])
    flow_frac = flows / flows.sum()

    # chunk -> path assignment: proportional to planned flow (both modes)
    chunk_path = rng.choice(len(paths), size=n_chunks, p=flow_frac)
    # per-hop queues per path: chunks ready to be sent on hop h
    ready: dict[tuple[int, int], list[int]] = {}
    for ch in range(n_chunks):
        ready.setdefault((int(chunk_path[ch]), 0), []).append(ch)
    # static (GridFTP) mode: pre-assign chunks round-robin to connections
    static_assign: dict[int, list[int]] = {}
    if dispatch == "static":
        by_first_hop: dict[int, list[int]] = {}
        for ci, c in enumerate(conns):
            if c.hop == 0:
                by_first_hop.setdefault(c.path_id, []).append(ci)
        rrobin: dict[int, int] = {}
        for ch in range(n_chunks):
            pid = int(chunk_path[ch])
            lst = by_first_hop[pid]
            k = rrobin.get(pid, 0)
            static_assign.setdefault(lst[k % len(lst)], []).append(ch)
            rrobin[pid] = k + 1

    relay_occupancy: dict[tuple[int, int], int] = {}  # (path, hop) buffered
    done_hops: set[tuple[int, int, int]] = set()
    delivered = 0
    now = 0.0
    edge_gbit: dict[tuple[int, int], float] = {}
    vm_busy_out = np.zeros(len(vm_eg_cap))
    vm_busy_in = np.zeros(len(vm_eg_cap))

    # speculation bookkeeping: (path,hop,chunk) -> replica count
    replicas: dict[tuple[int, int, int], int] = {}

    def refill(ci: int) -> bool:
        c = conns[ci]
        if c.chunk >= 0:
            return False
        # flow control: downstream relay buffer full -> stall
        key_down = (c.path_id, c.hop + 1)
        if c.hop + 1 < path_len[c.path_id]:
            if relay_occupancy.get(key_down, 0) >= relay_buffer_chunks:
                return False
        if dispatch == "static" and c.hop == 0:
            lst = static_assign.get(ci, [])
            if not lst:
                return False
            ch = lst.pop(0)
        else:
            q = ready.get((c.path_id, c.hop), [])
            if not q:
                if speculative:
                    return _speculate(ci)
                return False
            ch = q.pop(0)
        c.chunk = ch
        c.remaining = chunk_gbit
        if c.hop > 0:
            relay_occupancy[(c.path_id, c.hop)] = (
                relay_occupancy.get((c.path_id, c.hop), 0) - 1
            )
        return True

    def _speculate(ci: int) -> bool:
        """Idle conn + empty queue: duplicate the worst-ETA in-flight chunk
        on this (path, hop); first finisher wins, loser's bytes are wasted
        egress (billed)."""
        c = conns[ci]
        worst = None
        worst_eta = 0.0
        for cj in active_set:
            o = conns[cj]
            if cj == ci or o.chunk < 0:
                continue
            if (o.path_id, o.hop) != (c.path_id, c.hop):
                continue
            if replicas.get((o.path_id, o.hop, o.chunk), 1) >= 2:
                continue
            eta = o.remaining / max(o.rate_nominal * o.mult, _EPS)
            if eta > worst_eta:
                worst_eta, worst = eta, o.chunk
        own_eta = chunk_gbit / max(c.rate_nominal * c.mult, _EPS)
        if worst is None or worst_eta < 2.0 * own_eta:
            return False
        key = (c.path_id, c.hop, worst)
        replicas[key] = replicas.get(key, 1) + 1
        c.chunk = worst
        c.remaining = chunk_gbit
        return True

    max_events = n_chunks * 6 * max(path_len.values()) + 10000
    idle_set = set(range(len(conns)))
    active_set: set[int] = set()
    events = 0
    for _ in range(max_events):
        progressed = True
        while progressed:  # cascade refills (buffer drains unlock upstream)
            progressed = False
            for ci in list(idle_set):
                if refill(ci):
                    idle_set.discard(ci)
                    active_set.add(ci)
                    progressed = True
        active = [ci for ci in active_set if conns[ci].chunk >= 0]
        # speculation losers were cancelled in place; resync the sets
        for ci in list(active_set):
            if conns[ci].chunk < 0:
                active_set.discard(ci)
                idle_set.add(ci)
        if not active:
            break
        events += 1
        rates = _maxmin_rates(conns, active, vm_eg_cap, vm_in_cap)
        # next completion
        dt = min(
            conns[ci].remaining / max(rates[ci], _EPS) for ci in active
        )
        dt = max(dt, 1e-9)
        now += dt
        for ci in active:
            c = conns[ci]
            moved = rates[ci] * dt
            c.remaining -= moved
            edge_gbit[c.edge] = edge_gbit.get(c.edge, 0.0) + moved
            vm_busy_out[c.src_vm] += moved
            vm_busy_in[c.dst_vm] += moved
            if c.remaining <= 1e-9:
                ch = c.chunk
                c.chunk = -1
                c.remaining = 0.0
                key = (c.path_id, c.hop, ch)
                if key in done_hops:
                    continue  # a replica already finished this hop
                done_hops.add(key)
                if replicas.get(key, 1) > 1:
                    for o in conns:  # cancel the losing replica
                        if o.chunk == ch and (o.path_id, o.hop) == (c.path_id, c.hop):
                            o.chunk = -1
                            o.remaining = 0.0
                if c.hop + 1 < path_len[c.path_id]:
                    ready.setdefault((c.path_id, c.hop + 1), []).append(ch)
                    relay_occupancy[(c.path_id, c.hop + 1)] = (
                        relay_occupancy.get((c.path_id, c.hop + 1), 0) + 1
                    )
                else:
                    delivered += 1
        for ci in active:
            if conns[ci].chunk < 0:
                active_set.discard(ci)
                idle_set.add(ci)
        if delivered >= n_chunks:
            break

    time_s = max(now, 1e-9)
    tput = delivered * chunk_gbit / time_s
    per_edge_gb = {e: g / GBIT_PER_GB for e, g in edge_gbit.items()}
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
    for (a, b), gbit in edge_gbit.items():
        loc = "source_link" if a == src_r else "overlay_link"
        cap = top.tput[a, b] * max(plan.N[a], 1)
        u = gbit / max(cap * time_s, _EPS)
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
@dataclasses.dataclass
class _MConn:
    """Object-per-connection state of the multi-job reference loop."""

    job: int
    sid: int  # stage id
    edge_ix: int  # index into the scenario's edge list
    src_vm: int
    dst_vm: int
    rate: float  # effective (nominal * straggler mult * degrades)
    alive: bool = True
    chunk: int = -1
    remaining: float = 0.0


def _maxmin_rates_multi(conns, active_ix, vm_eg_cap, vm_in_cap, edge_rem0):
    """Water-filling over the active multi-job set: per-connection caps,
    per-VM egress/ingress caps, and the shared wide-area link caps."""
    n = len(active_ix)
    if n == 0:
        return {}
    caps = np.array([conns[i].rate for i in active_ix])
    src = np.array([conns[i].src_vm for i in active_ix], dtype=np.int64)
    dst = np.array([conns[i].dst_vm for i in active_ix], dtype=np.int64)
    nv = max(int(src.max()), int(dst.max())) + 1
    eg_rem = np.asarray(vm_eg_cap, dtype=float)[:nv].copy()
    in_rem = np.asarray(vm_in_cap, dtype=float)[:nv].copy()
    ne = 0
    if edge_rem0 is not None:
        eid = np.array([conns[i].edge_ix for i in active_ix], dtype=np.int64)
        ed_rem = edge_rem0.copy()
        ne = ed_rem.shape[0]

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
    return {int(active_ix[i]): float(rate[i]) for i in range(n)}


def simulate_multi_ref(
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
    """Object-per-connection oracle for ``flowsim.simulate_multi_soa``.

    Consumes the same materialized scenario (events.materialize_jobs, so the
    RNG streams and dispatch order match by construction) but runs the event
    loop on per-connection objects with dict/list bookkeeping — including
    multicast jobs (tree fan-out, per-destination delivery slots). The
    vectorized loop must reproduce its per-job delivered-chunk counts
    exactly (``exec_top`` included: the believed/true grid split changes
    rates, not materialization order)."""
    from .events import RATE_EVENTS, T_EPS, JobSimResult, MultiSimResult
    from .events import VMFailure, materialize_jobs, sorted_schedule
    from repro_torch.core.plan import MulticastPlan

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
    conns = [
        _MConn(
            job=int(su.conn_job[i]), sid=int(su.conn_sid[i]),
            edge_ix=int(su.conn_edge[i]), src_vm=int(su.conn_src[i]),
            dst_vm=int(su.conn_dst[i]), rate=float(su.conn_rate[i]),
        )
        for i in range(nc)
    ]
    edge_cap = None
    if link_capacity_scale is not None:
        edge_cap = np.array(
            [top.tput[a, b] * link_capacity_scale for a, b in su.edges_used]
        )

    vm_alive = [True] * su.vm_eg_cap.shape[0]
    arrived = [False] * J
    ready: dict[int, list[int]] = {s: [] for s in range(su.n_stages)}
    relay_occ: dict[int, int] = {}
    done_hops: set[tuple[int, int]] = set()
    enqueued: set[tuple[int, int]] = set()  # fan-in dedup on propagation
    delivered = [0] * su.slot_job.shape[0]
    retried = [0] * J
    finish: list[float | None] = [None] * J
    job_edge_gbit: dict[tuple[int, int], float] = {}

    sched = sorted_schedule(jobs, faults)
    ptr = 0
    now = 0.0
    tr = get_tracer()
    if tr.enabled:
        tr.instant("sim.start", 0.0, jobs=J, scheduled=len(sched))

    def apply_due():
        nonlocal ptr
        applied_t = None
        rate_n = 0
        while ptr < len(sched) and sched[ptr][0] <= now + T_EPS:
            t_ev = sched[ptr][0]
            ev = sched[ptr][2]
            ptr += 1
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
                # same compounding multiply as the vectorized loop — gray
                # or visible, the data plane cannot tell them apart
                want = (
                    su.edges_used.index((ev.src, ev.dst))
                    if (ev.src, ev.dst) in su.edges_used
                    else -1
                )
                for c in conns:
                    if c.edge_ix == want:
                        c.rate *= ev.factor
                if edge_cap is not None and want >= 0:
                    edge_cap[want] *= ev.factor
                # coalesced per batch below, exactly like the vectorized
                # loop — per-event instants would dominate gray/flap trains
                rate_n += 1
            elif isinstance(ev, VMFailure):
                kill = [
                    v for v in range(len(vm_alive))
                    if vm_alive[v] and su.vm_job[v] == ev.job
                    and su.vm_region[v] == ev.region
                ][: ev.count]
                requeued = 0
                if kill:
                    for v in kill:
                        vm_alive[v] = False
                    killset = set(kill)
                    for ci, c in enumerate(conns):
                        if not c.alive:
                            continue
                        if c.src_vm in killset or c.dst_vm in killset:
                            if c.chunk >= 0:
                                ready[c.sid].append(c.chunk)
                                if su.stage_hop[c.sid] > 0:
                                    relay_occ[c.sid] = (
                                        relay_occ.get(c.sid, 0) + 1
                                    )
                                retried[c.job] += 1
                                c.chunk = -1
                                c.remaining = 0.0
                                requeued += 1
                            c.alive = False
                if tr.enabled:
                    tr.instant("sim.vm_failure", t_ev, job=int(ev.job),
                               region=int(ev.region), killed=len(kill),
                               requeued=requeued)
            else:
                raise TypeError(f"unknown event {ev!r}")
        if applied_t is not None and tr.enabled:
            if rate_n:
                tr.instant("sim.rate_events", applied_t, n=rate_n)
            # mirrors the vectorized loop's post-batch link sample exactly
            counts = [0] * len(su.edges_used)
            for c in conns:
                if c.chunk >= 0:
                    counts[c.edge_ix] += 1
            for i, (a, b) in enumerate(su.edges_used):
                if counts[i]:
                    tr.sample(f"link {a}->{b}", applied_t, counts[i])

    def refill(ci: int) -> bool:
        c = conns[ci]
        if c.chunk >= 0 or not c.alive or not arrived[c.job]:
            return False
        for nsid in su.stage_children[c.sid]:
            if relay_occ.get(nsid, 0) >= relay_buffer_chunks:
                return False
        q = ready[c.sid]
        if not q:
            return False
        c.chunk = q.pop(0)
        c.remaining = float(su.chunk_gbit[c.job])
        if su.stage_hop[c.sid] > 0:
            relay_occ[c.sid] = relay_occ.get(c.sid, 0) - 1
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
        progressed = not draining
        while progressed:  # cascade refills (none while draining)
            progressed = False
            for ci in range(nc):
                if conns[ci].chunk < 0 and refill(ci):
                    progressed = True
        active = [ci for ci in range(nc) if conns[ci].chunk >= 0]
        t_next = (
            sched[ptr][0] if ptr < len(sched) and not draining else None
        )
        if not active:
            if t_next is not None and (
                horizon_s is None or t_next < horizon_s - T_EPS
            ):
                now = t_next
                continue
            break
        events += 1
        rates = _maxmin_rates_multi(
            conns, active, su.vm_eg_cap, su.vm_in_cap, edge_cap
        )
        if max(rates.values(), default=0.0) <= 1e-9 and t_next is None:
            break  # all remaining links dead: no progress possible, stall
        dt = min(
            conns[ci].remaining / max(rates[ci], _EPS) for ci in active
        )
        dt = max(dt, 1e-9)
        if t_next is not None and now + dt > t_next:
            dt = t_next - now
        horizon_hit = False
        if horizon_s is not None and now + dt >= horizon_s - T_EPS:
            if drain:
                draining = True  # past the boundary: in-flight only
            else:
                dt = horizon_s - now
                horizon_hit = True
        now += dt
        for ci in active:
            c = conns[ci]
            moved = rates[ci] * dt
            c.remaining -= moved
            jkey = (c.job, c.edge_ix)
            job_edge_gbit[jkey] = job_edge_gbit.get(jkey, 0.0) + moved
            if c.remaining <= 1e-9:
                ch = c.chunk
                c.chunk = -1
                c.remaining = 0.0
                key = (c.sid, ch)
                if key in done_hops:
                    continue
                done_hops.add(key)
                slot = int(su.stage_deliver[c.sid])
                if slot >= 0:
                    delivered[slot] += 1
                    jj = int(su.slot_job[slot])
                    if delivered[slot] >= su.n_chunks[jj] and all(
                        delivered[s] >= su.n_chunks[jj]
                        for s in su.job_slots[jj]
                    ):
                        finish[jj] = now
                        if tr.enabled:
                            tr.instant("sim.job_done", now, job=jj)
                for nsid in su.stage_children[c.sid]:
                    if (nsid, ch) in enqueued:
                        continue  # another in-edge already fed this stage
                    enqueued.add((nsid, ch))
                    ready[nsid].append(ch)
                    relay_occ[nsid] = relay_occ.get(nsid, 0) + 1
        if horizon_hit:
            break
        if all(f is not None for f in finish):
            break

    horizon_cut = horizon_s is not None and now >= horizon_s - T_EPS
    out = []
    for j, job in enumerate(jobs):
        end = finish[j] if finish[j] is not None else now
        dur = max(end - float(su.arrivals[j]), 1e-9)
        eg_cost = 0.0
        per_edge_gb = {}
        for i, (a, b) in enumerate(su.edges_used):
            gbit = job_edge_gbit.get((j, i), 0.0)
            eg_cost += gbit / GBIT_PER_GB * top.price_egress[a, b]
            if gbit > 0:
                per_edge_gb[f"{a}->{b}"] = gbit / GBIT_PER_GB
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
            chunks_in_flight=sum(
                1 for c in conns if c.job == j and c.chunk >= 0
            ),
        ))
    if tr.enabled:
        tr.instant("sim.end", now,
                   delivered=sum(int(r.chunks_delivered) for r in out))
    return MultiSimResult(jobs=out, time_s=now, events=events)
