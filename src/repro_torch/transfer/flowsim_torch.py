"""Device-resident multi-job flow simulator (fixed-shape torch).

The port of the reference package's ``transfer/flowsim_jax.py``, the
accelerator engine of the ``transfer.sim`` dispatcher. It consumes the
same ``events.materialize_jobs`` scenario and returns the same
``MultiSimResult``, chunk for chunk and bit for bit: the event loop runs on
the device over padded structure-of-arrays state with validity masks, and
the host keeps only the scripted schedule. Each segment of the loop runs
until the next scripted event is due; the host applies it (numpy, the
exact reference logic, emitting the same Skytrace stream) and re-enters.

How the loop runs without ``lax.while_loop``:

  * every iteration is fully predicated on a device flag ``go`` (not
    stopped, under the iteration budget, no scripted event due); every
    update, the iteration count included, is masked with it, so a stopped
    state is a fixed point. The host runs blocks of ``block`` iterations
    and reads the flags once per block, so the result does not depend on
    the block size;
  * on the card each block is one CUDA graph, the counterpart of the
    reference's compiled ``while_loop`` segment: a graph per block length
    in use (``block``, and 1, 2, 4, ... after a sequential cascade). The
    first use of a length in a run runs eagerly, which is also the
    warm-up (first-call set-up such as the kernels' shared-memory
    attribute happens there, outside any capture); its second use
    captures the graph, and that use and every later one replay it, so a
    length used once costs no capture. A capture or replay error raises;
    nothing falls back to eager blocks.
    On the CPU the same blocks run eagerly. The state's tensors keep
    their storage for the whole run (the host writes them with ``copy_``
    / ``fill_`` / ``zero_``). Replays add the launches each graph
    recorded to the kernels' launch counters (``wf.GRAPH_COUNTERS``,
    ``ss.GRAPH_COUNTERS``);
  * on the card an iteration is three launches that update the state's
    tensors in place (``_iteration_card``): ``sim_pre_f64`` (the loop
    flag, the head of ``_iteration``, the batched refill and the solve's
    membership flags), the water-filling solve, and ``sim_post_f64`` (the
    rest of ``_step``), so a graph records three kernel nodes an
    iteration. The torch ops of ``_iteration`` / ``_cascade_batch`` /
    ``_step`` are the CPU's plain version, which the kernels are held
    against; they run on a working copy of the state that ``_run``
    copies back into the state's own tensors at the block's end. There
    is no fallback to them on the card;
  * the host's phases are ``obs.trace.host_span``s, each adding its wall
    seconds to a counter (``sim.build_s``, ``sim.block.replay_s``,
    ``sim.flags_s``, ...) and, with the tracer on, an event on the
    ``host`` track carrying the call's id under the root ``sim.call``.
    Beside them: ``sim.flag_reads``; ``sim.block_gap_s``, the host's
    time from a flag read's return to the return of the next replay's
    launch (what the card waits on between blocks); and
    ``sim.replay_device_s``, the card's time in each replayed graph, from
    one pair of CUDA events around the replay, read after the flag read
    that synchronises anyway;
  * the water-filling solve is behind the device flag ``changed`` (active
    membership moved or the cache was invalidated), which the kernel reads
    itself and answers with the cached rates, so no iteration syncs. The
    state's ``solves`` adds up ``changed`` as the solve read it
    (``sim_post_f64`` on the card, after the host's sequential cascade
    too; the torch ops on the CPU); ``_finalize`` adds it to the counter
    ``sim.solves`` with its other reads, so ``sim.solves`` over
    ``sim.iterations`` is the share of iterations that paid for a real
    solve. They are the solves the numpy engine makes on the same inputs
    (it solves when its active set moves or an event invalidated its
    rates);
  * the exact sequential cascade (some relay buffer at capacity, rare and
    inherently serial) also freezes ``go``; the host then runs that one
    iteration with the cascade in numpy and returns to the device blocks.
    Scenarios without relay stages can never need it and skip the check.

Exact-semantics notes (each is load-bearing for chunk-for-chunk parity):

  * ``None`` horizons / exhausted schedules are +inf, as in the reference;
  * eager torch rounds ``rates * dt`` and ``remaining - moved`` as separate
    operations, so no multiply-add is ever fused;
  * the per-(job, edge) Gbit sums add their lanes in ascending connection
    order (``segment_sum_ordered``'s ``index_add_`` on the CPU, a fold in
    ``sim_post_f64`` on the card), as the reference's ``segment_sum`` and
    the numpy engine's ``bincount`` do. Integer segment sums may add in
    any order;
  * scatters that several lanes may hit write the same value to a dump
    row (stage ``ns`` / job ``J``), so which write lands does not matter.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.plan import MulticastPlan
from repro_torch.core.topology import GBIT_PER_GB
from repro_torch.device import resolve_device
from repro_torch.kernels.simstep import ops as ss
from repro_torch.kernels.waterfill import ops as wf
from repro_torch.kernels.waterfill.ref import BIG
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import get_tracer, host_span

from .events import T_EPS
from .simconfig import SimConfig
from .simconfig import resolve as resolve_sim_config

_EPS = 1e-12  # the numpy engine's _EPS
_INF = float("inf")
RATE_SOLVERS = ("f64", "f32")
# iterations that took the host-side sequential cascade (a relay buffer full)
_seq_cascades = REGISTRY.counter("sim.seq_cascades")
_graph_captures = REGISTRY.counter("sim.graph_captures")
_graph_replays = REGISTRY.counter("sim.graph_replays")
# predicated loop iterations the device ran, live or frozen (one launch of
# each sim kernel apiece)
_iterations = REGISTRY.counter("sim.iterations")
# water-filling solves the sim's iterations made (the rest answered from the
# cached rates), read from the state's ``solves`` when a sim ends
_solves = REGISTRY.counter("sim.solves")
_flag_reads = REGISTRY.counter("sim.flag_reads")
_block_gap_s = REGISTRY.counter("sim.block_gap_s")
_replay_device_s = REGISTRY.counter("sim.replay_device_s")
_call_ids = itertools.count(1)  # a call's id, on each of its host spans
# (recorded under capture, launched) counter pairs of every kernel a block
# of iterations launches on the card
_GRAPH_COUNTERS = wf.GRAPH_COUNTERS + ss.GRAPH_COUNTERS


class _Sc(NamedTuple):
    """Static shape/config of one scenario."""

    ncp: int  # conns padded to a multiple of 8
    ns: int  # stages (buffers carry one extra dump row)
    j: int  # jobs
    nslot: int  # completion slots
    ne: int  # shared edges
    qcap: int  # ready-queue ring capacity (>= max chunks per job)
    maxch: int  # max children per stage
    maxcs: int  # max conns per stage (sequential-cascade window)
    nv: int  # VMs
    ne_bound: int  # edge count in the f64 round bound (0 without contention)
    solver: str  # "f64" (parity) | "f32" (the TPU kernel's counterpart)
    seq_possible: bool  # some stage relays, so a buffer can fill up
    horizon: float  # +inf when None
    drain: bool
    relay_cap: int
    max_events: int


@dataclasses.dataclass
class _Cn:
    """Per-scenario constants on the device, plus host copies for the
    sequential cascade."""

    conn_job: torch.Tensor
    conn_sid: torch.Tensor
    conn_valid: torch.Tensor
    chunk_size: torch.Tensor
    conn_first: torch.Tensor  # first conn index of this conn's stage
    stage_hop: torch.Tensor  # [NS + 1]
    stage_deliver: torch.Tensor  # [NS + 1]
    children: torch.Tensor  # [NS + 1, MAXCH], -1 padded
    slot_job: torch.Tensor
    slot_need: torch.Tensor  # n_chunks of the slot's job
    vm_eg: torch.Tensor
    vm_in: torch.Tensor
    src32: torch.Tensor  # int32 conn -> VM maps for the kernel
    dst32: torch.Tensor
    eid32: torch.Tensor
    segs: wf.Segments  # CSR lists of the maps above
    # the water-filling cluster kernel's lane scratch when a solve's lanes
    # do not fit one block's shared memory, else None; allocated once here,
    # outside any graph capture
    wf_lanes: torch.Tensor | None
    je: torch.Tensor  # [NCp] job * NE + edge
    je_lists: tuple  # CSR lists of je
    rows: torch.Tensor  # [NS + 1, 1] stage ids (cascade window gather)
    win: torch.Tensor  # [1, MAXCS] window offsets
    host: dict  # numpy copies for the host-side sequential cascade
    # on the card, the sim-step kernels bound to this sim's state, their
    # scratch included (set by ``_build``); None on the CPU
    step: ss.Bound | None = None


@dataclasses.dataclass
class _St:
    """Mutable simulation state."""

    now: torch.Tensor
    it: torch.Tensor  # loop iterations (the reference's for-range budget)
    events: torch.Tensor  # iterations that reached the rate step
    draining: torch.Tensor
    stop: torch.Tensor  # terminal break reached
    t_sched: torch.Tensor  # next unapplied scripted event time (+inf)
    chunk_arr: torch.Tensor  # [NCp] chunk id in flight, -1 idle
    remaining: torch.Tensor  # [NCp] Gbit left of the in-flight chunk
    rate_eff: torch.Tensor  # [NCp] per-conn cap (host scales on events)
    conn_alive: torch.Tensor
    arrived: torch.Tensor  # [J]
    ready_buf: torch.Tensor  # [NS + 1, QCAP] ring buffers (+ dump row)
    q_head: torch.Tensor  # [NS + 1] monotonic pop counter
    q_tail: torch.Tensor  # [NS + 1] monotonic push counter
    relay_occ: torch.Tensor  # [NS + 1]
    done_bm: torch.Tensor  # [NS + 1, QCAP] hop-completion dedup
    enq_bm: torch.Tensor  # [NS + 1, QCAP] fan-in enqueue dedup
    delivered: torch.Tensor  # [NSLOT]
    finished: torch.Tensor  # [J]
    finish: torch.Tensor  # [J] f64, +inf until finished
    jeg: torch.Tensor  # [J * NE] per-(job, edge) Gbit moved
    jeo: torch.Tensor  # [J * NE] observation-window Gbit
    jeb: torch.Tensor  # [J * NE] observation-window busy seconds
    edge_cap: torch.Tensor  # [NE] shared caps (BIG when disabled)
    rates: torch.Tensor  # [NCp] cached water-filling solution
    last_active: torch.Tensor  # [NCp] membership the cache was solved for
    rates_valid: torch.Tensor
    td_time: torch.Tensor  # [J + 1] buffered sim.job_done instants
    td_job: torch.Tensor
    td_n: torch.Tensor
    solves: torch.Tensor  # iterations whose ``changed`` held: real solves


def _segsum_int(vals, idx, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.int64, device=vals.device)
    return out.index_add_(0, idx, vals.to(torch.int64))


def _compute_rates(st: _St, cn: _Cn, sc: _Sc, active, changed):
    if sc.solver == "f32":
        f32 = torch.float32
        r = wf.waterfill_rates(
            st.rate_eff.to(f32), cn.src32, cn.dst32, cn.vm_eg.to(f32),
            cn.vm_in.to(f32), cn.eid32, st.edge_cap.to(f32), active,
            precision="f32", changed=changed,
            prev=st.rates.to(f32), segments=cn.segs, lanes=cn.wf_lanes,
        )
        return r.to(st.rates.dtype)
    return wf.waterfill_rates(
        st.rate_eff, cn.src32, cn.dst32, cn.vm_eg, cn.vm_in, cn.eid32,
        st.edge_cap, active, precision="f64", n_edges_bound=sc.ne_bound,
        changed=changed, prev=st.rates, segments=cn.segs,
        lanes=cn.wf_lanes,
    )


def _use_seq(st: _St, sc: _Sc):
    if not sc.seq_possible:
        return torch.zeros((), dtype=torch.bool, device=st.now.device)
    return (st.relay_occ[: sc.ns] >= sc.relay_cap).any()


def _base_go(st: _St, sc: _Sc):
    """The reference's loop condition, on the device."""
    would = ~st.draining & (st.t_sched <= st.now + T_EPS)
    return ~st.stop & (st.it < sc.max_events) & ~would


def _cascade_batch(st: _St, cn: _Cn, sc: _Sc, run) -> None:
    """Single-pass batched refill — exact while no relay buffer is full.
    ``run`` predicates the whole pass."""
    idle = (
        run & (st.chunk_arr < 0) & st.conn_alive
        & st.arrived[cn.conn_job] & cn.conn_valid
    )
    qlen = st.q_tail - st.q_head
    elig = idle & (qlen[cn.conn_sid] > 0)
    ef = elig.to(torch.int64)
    excl = torch.cumsum(ef, 0) - ef
    rank = excl - excl[cn.conn_first]
    take = elig & (rank < qlen[cn.conn_sid])
    row = torch.where(take, cn.conn_sid, sc.ns)
    pos = (st.q_head[row] + rank) % sc.qcap
    ch = st.ready_buf[row, torch.where(take, pos, 0)]
    cnt = _segsum_int(take, row, sc.ns + 1)
    st.chunk_arr = torch.where(take, ch, st.chunk_arr)
    st.remaining = torch.where(take, cn.chunk_size, st.remaining)
    st.q_head = st.q_head + cnt
    st.relay_occ = st.relay_occ - torch.where(cn.stage_hop > 0, cnt, 0)


def _cascade_seq(st: _St, cn: _Cn, sc: _Sc) -> np.ndarray:
    """Exact sequential replication of the reference cascade passes, on
    the host. A cascade takes at most one chunk per conn, so a window of
    ``maxcs`` queue entries past each head covers every take. Returns the
    lanes' chunks after it (host copy)."""
    h = cn.host
    win = st.ready_buf[cn.rows, (st.q_head[:, None] + cn.win) % sc.qcap]
    chunk_arr, remaining, q_head, relay_occ, q_tail, alive, arrived, win = (
        t.cpu().numpy().copy() for t in (
            st.chunk_arr, st.remaining, st.q_head, st.relay_occ, st.q_tail,
            st.conn_alive, st.arrived, win,
        )
    )
    q0 = q_head.copy()
    while True:
        idle = (
            (chunk_arr < 0) & alive & arrived[h["conn_job"]] & h["conn_valid"]
        )
        if not idle.any():
            break
        cand = idle & ((q_tail - q_head)[h["conn_sid"]] > 0)
        prog = False
        for i in np.flatnonzero(cand):
            sid = h["conn_sid"][i]
            kids = h["children"][sid]
            kids = kids[kids >= 0]
            if kids.size and (relay_occ[kids] >= sc.relay_cap).any():
                continue
            if q_tail[sid] <= q_head[sid]:
                continue
            chunk_arr[i] = win[sid, q_head[sid] - q0[sid]]
            remaining[i] = h["chunk_size"][i]
            q_head[sid] += 1
            if h["stage_hop"][sid] > 0:
                relay_occ[sid] -= 1
            prog = True
        if not prog:
            break
    st.chunk_arr.copy_(torch.from_numpy(chunk_arr))
    st.remaining.copy_(torch.from_numpy(remaining))
    st.q_head.copy_(torch.from_numpy(q_head))
    st.relay_occ.copy_(torch.from_numpy(relay_occ))
    return chunk_arr


def _step(st: _St, cn: _Cn, sc: _Sc, go) -> None:
    """Rate solve + stall check + fluid step + event-less jump, merged and
    predicated on ``go`` (False leaves the state exactly as it was)."""
    i64 = torch.int64
    active = st.chunk_arr >= 0
    has_active = active.any()
    live = go & ~st.stop
    work = live & has_active
    jump = live & ~has_active
    events = st.events + work.to(i64)

    changed = work & (~st.rates_valid | (active != st.last_active).any())
    rates = _compute_rates(st, cn, sc, active, changed)
    solves = st.solves + changed.to(i64)
    last_active = torch.where(work, active, st.last_active)
    rates_valid = st.rates_valid | work
    t_next = torch.where(st.draining, _INF, st.t_sched)
    finite_next = torch.isfinite(t_next)
    stalled = work & (rates.amax() <= 1e-9) & ~finite_next
    adv = work & ~stalled
    jok = finite_next & (t_next < sc.horizon - T_EPS)

    # ---- fluid step: the reference's formulas; every consumer masks on
    # ``adv`` (the garbage they produce when adv is False never lands)
    safe = torch.clamp(rates, min=_EPS)
    ratio = torch.where(active, st.remaining / safe, _INF)
    dt = torch.clamp(ratio.amin(), min=1e-9)
    dt = torch.where(finite_next & (st.now + dt > t_next), t_next - st.now, dt)
    obs_live = ~st.draining  # telemetry window ends where the drain starts
    cross = adv & (st.now + dt >= sc.horizon - T_EPS)
    if sc.drain:
        horizon_hit = torch.zeros_like(cross)
        draining = st.draining | cross
    else:
        horizon_hit = cross
        draining = st.draining
    dt = torch.where(horizon_hit, sc.horizon - st.now, dt)
    now = torch.where(
        adv, st.now + dt, torch.where(jump & jok, t_next, st.now)
    )

    moved = rates * dt
    act_adv = active & adv
    remaining = torch.where(act_adv, st.remaining - moved, st.remaining)
    w = torch.where(act_adv, moved, 0.0)
    seg = wf.segment_sum_ordered(w, cn.je, sc.j * sc.ne, lists=cn.je_lists)
    jeg = torch.where(adv, st.jeg + seg, st.jeg)
    je_on = _segsum_int(act_adv, cn.je, sc.j * sc.ne) > 0
    jeo = torch.where(adv & obs_live, st.jeo + seg, st.jeo)
    jeb = torch.where(adv & obs_live & je_on, st.jeb + dt, st.jeb)

    # ---- batched hop completions (ascending-conn order is preserved:
    # one parent per child stage, contiguous conns per stage)
    completed = act_adv & (remaining <= 1e-9)
    ch = torch.clamp(st.chunk_arr, min=0)
    sid = cn.conn_sid
    newdone = completed & ~st.done_bm[sid, ch]
    done_bm = st.done_bm.index_put(
        (torch.where(newdone, sid, sc.ns), torch.where(newdone, ch, 0)),
        newdone,
    )
    slot = cn.stage_deliver[sid]
    sval = newdone & (slot >= 0)
    delivered = st.delivered + _segsum_int(
        sval, torch.clamp(slot, min=0), sc.nslot
    )
    ok_slot = delivered >= cn.slot_need
    bad = _segsum_int(~ok_slot, cn.slot_job, sc.j)
    job_ok = adv & (bad == 0)
    newly = job_ok & ~st.finished
    finished = st.finished | job_ok
    finish = torch.where(newly, now, st.finish)
    nf = newly.to(i64)
    idx = torch.where(newly, st.td_n + torch.cumsum(nf, 0) - nf, sc.j)
    jobs = torch.arange(sc.j, dtype=i64, device=nf.device)
    td_time = st.td_time.index_put((idx,), now.expand(sc.j))
    td_job = st.td_job.index_put((idx,), torch.where(newly, jobs, sc.j))
    td_n = st.td_n + nf.sum()

    ready_buf, q_tail, relay_occ, enq_bm = (
        st.ready_buf, st.q_tail, st.relay_occ, st.enq_bm
    )
    for k in range(sc.maxch):
        nsid = cn.children[sid, k]
        has = newdone & (nsid >= 0)
        nsid_cl = torch.where(has, nsid, sc.ns)
        val = has & ~enq_bm[nsid_cl, ch]
        vf = val.to(i64)
        excl = torch.cumsum(vf, 0) - vf
        rank = excl - excl[cn.conn_first]
        row = torch.where(val, nsid_cl, sc.ns)
        pos = torch.where(val, (q_tail[row] + rank) % sc.qcap, 0)
        ready_buf = ready_buf.index_put(
            (row, pos), torch.where(val, ch, ready_buf[row, pos])
        )
        cnt = _segsum_int(val, row, sc.ns + 1)
        q_tail = q_tail + cnt
        relay_occ = relay_occ + cnt
        enq_bm = enq_bm.index_put((row, torch.where(val, ch, 0)), val)

    stop = torch.where(
        adv, horizon_hit | finished.all(),
        torch.where(jump, ~jok, stalled | st.stop),
    )
    st.now, st.draining, st.stop, st.events = now, draining, stop, events
    st.solves = solves
    st.rates, st.last_active, st.rates_valid = rates, last_active, rates_valid
    st.chunk_arr = torch.where(completed, -1, st.chunk_arr)
    st.remaining = torch.where(completed, 0.0, remaining)
    st.ready_buf, st.q_tail, st.relay_occ = ready_buf, q_tail, relay_occ
    st.done_bm, st.enq_bm, st.delivered = done_bm, enq_bm, delivered
    st.finished, st.finish = finished, finish
    st.jeg, st.jeo, st.jeb = jeg, jeo, jeb
    st.td_time, st.td_job, st.td_n = td_time, td_job, td_n


def _iteration(st: _St, cn: _Cn, sc: _Sc, go, *, seq: bool) -> None:
    """One iteration of the reference loop body under the flag ``go``.
    ``seq`` runs the host-side sequential cascade in place of the batched
    one (the host has checked that ``go`` holds and a buffer is full)."""
    st.it = st.it + go.to(torch.int64)
    cross = st.now >= sc.horizon - T_EPS
    if sc.drain:
        st.draining = st.draining | (go & cross)
    else:
        st.stop = torch.where(go, cross, st.stop)
    run = go & ~st.stop & ~st.draining
    if seq:
        if bool(run):
            _cascade_seq(st, cn, sc)
    else:
        _cascade_batch(st, cn, sc, run)
    _step(st, cn, sc, go)


def _iteration_card(st: _St, cn: _Cn, sc: _Sc, *, seq: bool) -> None:
    """One iteration on the card, three launches that update the state in
    place: ``sim_pre_f64`` (``go``, the head of ``_iteration``, the batched
    refill, the solve's membership flags), the water-filling solve, and
    ``sim_post_f64`` (the rest of ``_step``). ``seq``: the refill is the
    host's sequential cascade, run between the first launch and the solve
    where ``run`` holds, after which the host sets the membership flags."""
    k = cn.step
    ss.sim_pre_f64(k, seq=seq)
    if seq and bool(k.scratch.run):
        chunk_arr = _cascade_seq(st, cn, sc)
        # ``run`` held, so ``work`` is whether any lane is active
        active = chunk_arr >= 0
        changed = bool(active.any()) and (
            not bool(st.rates_valid)
            or bool((active != st.last_active.cpu().numpy()).any()))
        k.scratch.active.copy_(torch.from_numpy(active))
        k.scratch.changed.fill_(changed)
    rates = _compute_rates(st, cn, sc, k.scratch.active, k.scratch.changed)
    ss.sim_post_f64(k, rates)


_FIELDS = tuple(f.name for f in dataclasses.fields(_St))


def _run(st: _St, cn: _Cn, sc: _Sc, n: int, *, seq: bool = False) -> None:
    """``n`` loop iterations (``seq``: one iteration with the host-side
    cascade). On the card each is ``_iteration_card``'s three launches; on
    the CPU the torch ops run on a working copy of the state, written back
    into the state's own tensors. Either way their storage never
    changes."""
    if cn.step is not None:
        for _ in range(n):
            _iteration_card(st, cn, sc, seq=seq)
        return
    w = dataclasses.replace(st)
    for _ in range(n):
        go = _base_go(w, sc)
        if not seq:
            go = go & ~_use_seq(w, sc)
        _iteration(w, cn, sc, go, seq=seq)
    for f in _FIELDS:
        new, own = getattr(w, f), getattr(st, f)
        if new is not own:
            own.copy_(new)


class _Blocks:
    """Runs blocks of predicated iterations: eagerly on the CPU; on the
    card eagerly at a block length's first use in the run, then as one
    CUDA graph per length, captured at its second use and replayed from
    then on. ``call`` is the sim call's id, for its host spans."""

    def __init__(self, st: _St, cn: _Cn, sc: _Sc, call: int):
        self.st, self.cn, self.sc, self.call = st, cn, sc, call
        self.graphs: dict = {}  # length -> (graph, launches it records)
        # one pair of CUDA events around each replay, reused: the device
        # time of the last replay, read once it has ended
        self.timing = None
        if st.now.device.type == "cuda":
            self.timing = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        self.timed = False  # the pair holds a replay not read yet

    def run(self, n: int) -> bool:
        """Run one block of ``n`` iterations; True where it was the replay
        of a graph captured before this call."""
        st, cn, sc = self.st, self.cn, self.sc
        _iterations.inc(n)
        cuda = st.now.device.type == "cuda"
        if not cuda or n not in self.graphs:
            if cuda:  # first use: eager, the warm-up
                self.graphs[n] = None
            with host_span("sim.block.eager", call=self.call):
                _run(st, cn, sc, n)
            return False
        replay = self.graphs[n] is not None
        if not replay:
            with host_span("sim.block.capture",
                           counter="sim.graph_capture_s", call=self.call):
                self.graphs[n] = self._capture(n)
        graph, recorded = self.graphs[n]
        start, end = self.timing
        with host_span("sim.block.replay", call=self.call):
            start.record()
            graph.replay()
            end.record()
        self.timed = True
        _graph_replays.inc()
        for (_, launches), k in zip(_GRAPH_COUNTERS, recorded):
            if k:
                launches.inc(k)
        return replay

    def read_device_time(self) -> None:
        """Add the last replay's device seconds to ``sim.replay_device_s``;
        called after a read that waited for the replay to end."""
        if self.timed:
            start, end = self.timing
            _replay_device_s.inc(start.elapsed_time(end) * 1e-3)
            self.timed = False

    def _capture(self, n: int):
        """Capture the block (already run eagerly once); returns (graph,
        launches it records per counter pair)."""
        st, cn, sc = self.st, self.cn, self.sc
        before = [r.value for r, _ in _GRAPH_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _run(st, cn, sc, n)
        _graph_captures.inc()
        recorded = [r.value - b for (r, _), b in zip(_GRAPH_COUNTERS, before)]
        return graph, recorded


def _segment(st: _St, cn: _Cn, sc: _Sc, block: int,
             blocks: _Blocks) -> None:
    """Run loop iterations until a scripted event is due (the host applies
    it and re-enters), a terminal break is reached, or the iteration
    budget is spent. The flags are read after each run of up to ``block``
    iterations; after a sequential cascade the runs restart at one
    iteration and double, so a buffer that stays full does not leave the
    device spinning through frozen iterations."""
    n = block
    read = None  # the last flag read's return, where a replay follows it
    while True:
        if blocks.run(n) and read is not None:
            _block_gap_s.inc(time.perf_counter() - read)
        with host_span("sim.flags", call=blocks.call):
            flags = torch.stack([_base_go(st, sc), _use_seq(st, sc)]).tolist()
        read = time.perf_counter()
        _flag_reads.inc()
        blocks.read_device_time()
        if not flags[0]:
            return
        if flags[1]:
            with host_span("sim.cascade_seq", call=blocks.call):
                _run(st, cn, sc, 1, seq=True)
            read = None
            _iterations.inc()
            _seq_cascades.inc()
            n = 1
        else:
            n = min(2 * n, block)


# ------------------------------------------------------------------ host side
def _wf_lanes(ncp: int, nv: int, ne: int, solver: str, dev):
    """The lane scratch that sends every solve of this scenario to the
    water-filling cluster kernel, where one block's shared memory does not
    take it (``needs_cluster``); None where it does. The CPU's plain
    solver ignores it."""
    if not wf.needs_cluster(ncp, nv, ne, solver):
        return None
    n = wf.scratch_bytes(ncp, 8 if solver == "f64" else 4)
    return torch.empty(n, dtype=torch.uint8, device=dev)


def _build(su, cfg, sched, solver: str, dev):
    """Materialized scenario -> (static config, constants, initial state)."""
    nc = int(su.conn_job.shape[0])
    ncp = max(8, -(-nc // 8) * 8)
    ns = int(su.n_stages)
    j = int(su.arrivals.shape[0])
    nslot = int(su.slot_job.shape[0])
    ne = len(su.edges_used)
    nv = int(su.vm_eg_cap.shape[0])
    qcap = max(1, int(su.n_chunks.max()))
    maxch = max((len(c) for c in su.stage_children), default=0)
    maxcs = max(1, int(np.bincount(su.conn_sid, minlength=ns).max()))

    def padc(a, fill):
        out = np.full(ncp, fill, dtype=np.asarray(a).dtype)
        out[:nc] = a
        return out

    def pads(a, fill):
        out = np.full(ns + 1, fill, dtype=np.asarray(a).dtype)
        out[:ns] = a
        return out

    children = np.full((ns + 1, maxch), -1, dtype=np.int64)
    for s, kids in enumerate(su.stage_children):
        children[s, : len(kids)] = kids
    first_ci = np.searchsorted(su.conn_sid, np.arange(ns))
    conn_first = padc(first_ci[su.conn_sid], 0)

    use_edge = cfg.link_capacity_scale is not None
    if use_edge:
        edge_cap = np.array([
            su.top.tput[a, b] * cfg.link_capacity_scale
            for a, b in su.edges_used
        ])
    else:
        edge_cap = np.full(ne, BIG)

    max_events = (
        int((su.n_chunks * 6).sum()) * su.max_hops + 10000 + 8 * len(sched)
    )
    sc = _Sc(
        ncp=ncp, ns=ns, j=j, nslot=nslot, ne=ne, qcap=qcap, maxch=maxch,
        maxcs=maxcs, nv=nv, ne_bound=ne if use_edge else 0, solver=solver,
        seq_possible=bool((su.stage_hop > 0).any())
        or cfg.relay_buffer_chunks <= 0,
        horizon=_INF if cfg.horizon_s is None else float(cfg.horizon_s),
        drain=bool(cfg.drain), relay_cap=int(cfg.relay_buffer_chunks),
        max_events=max_events,
    )
    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    conn_sid = padc(su.conn_sid, ns)
    conn_job = padc(su.conn_job, 0)
    conn_valid = np.arange(ncp) < nc
    chunk_size = padc(su.chunk_gbit[su.conn_job], 0.0)
    src32 = t(padc(su.conn_src, 0), torch.int32)
    dst32 = t(padc(su.conn_dst, 0), torch.int32)
    eid32 = t(padc(su.conn_edge, 0), torch.int32)
    je = t(conn_job * ne + padc(su.conn_edge, 0))
    cn = _Cn(
        conn_job=t(conn_job), conn_sid=t(conn_sid), conn_valid=t(conn_valid),
        chunk_size=t(chunk_size), conn_first=t(conn_first),
        stage_hop=t(pads(su.stage_hop, 0)),
        stage_deliver=t(pads(su.stage_deliver, -1)),
        children=t(children), slot_job=t(su.slot_job),
        slot_need=t(su.n_chunks[su.slot_job]),
        vm_eg=t(su.vm_eg_cap, torch.float64),
        vm_in=t(su.vm_in_cap, torch.float64),
        src32=src32, dst32=dst32, eid32=eid32,
        segs=wf.build_segments(src32, dst32, eid32, nv, ne),
        wf_lanes=_wf_lanes(ncp, nv, ne, solver, dev),
        je=je, je_lists=wf.csr(je, j * ne),
        rows=torch.arange(ns + 1, device=dev)[:, None],
        win=torch.arange(maxcs, device=dev)[None, :],
        host={
            "conn_job": conn_job, "conn_sid": conn_sid,
            "conn_valid": conn_valid, "chunk_size": chunk_size,
            "children": children, "stage_hop": pads(su.stage_hop, 0),
        },
    )
    f64 = torch.float64

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def own(a, dtype=None):  # state storage of its own (never numpy's)
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    st = _St(
        now=full((), 0.0, f64), it=full((), 0, torch.int64),
        events=full((), 0, torch.int64),
        draining=full((), False, torch.bool), stop=full((), False, torch.bool),
        t_sched=full((), sched[0][0] if sched else _INF, f64),
        chunk_arr=full((ncp,), -1, torch.int64),
        remaining=full((ncp,), 0.0, f64),
        rate_eff=own(padc(su.conn_rate, 0.0), f64),
        conn_alive=own(conn_valid),
        arrived=full((j,), False, torch.bool),
        ready_buf=full((ns + 1, qcap), 0, torch.int64),
        q_head=full((ns + 1,), 0, torch.int64),
        q_tail=full((ns + 1,), 0, torch.int64),
        relay_occ=full((ns + 1,), 0, torch.int64),
        done_bm=full((ns + 1, qcap), False, torch.bool),
        enq_bm=full((ns + 1, qcap), False, torch.bool),
        delivered=full((nslot,), 0, torch.int64),
        finished=full((j,), False, torch.bool),
        finish=full((j,), _INF, f64),
        jeg=full((j * ne,), 0.0, f64), jeo=full((j * ne,), 0.0, f64),
        jeb=full((j * ne,), 0.0, f64),
        edge_cap=own(edge_cap, f64),
        rates=full((ncp,), 0.0, f64),
        last_active=full((ncp,), False, torch.bool),
        rates_valid=full((), False, torch.bool),
        td_time=full((j + 1,), 0.0, f64),
        td_job=full((j + 1,), 0, torch.int64),
        td_n=full((), 0, torch.int64),
        solves=full((), 0, torch.int64),
    )
    if torch.device(dev).type == "cuda":
        _card_libraries()
        cn.step = ss.bind(*_step_inputs(st, cn, sc), ss.scratch(ncp, dev))
    return sc, cn, st


def _card_libraries() -> None:
    """Build and load the card's sim libraries (water-filling and sim
    step) at the first card sim of a process, one nvcc each, together."""
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.simstep import build as ss_build
    from repro_torch.kernels.waterfill import build as wf_build

    nvcc.build_all([wf_build.LIBRARY, ss_build.LIBRARY])


def _step_inputs(st: _St, cn: _Cn, sc: _Sc) -> tuple[dict, dict]:
    """The tensors (by ``ss.TENSORS``' names, but the scratch) and the
    sizes and constants the sim-step kernels take."""
    tensors = {f: getattr(st, f) for f in _FIELDS}
    tensors.update(
        (f, getattr(cn, f)) for f in (
            "conn_job", "conn_sid", "conn_valid", "chunk_size",
            "conn_first", "stage_hop", "stage_deliver", "children",
            "slot_job", "slot_need"))
    tensors["je_off"], tensors["je_idx"] = cn.je_lists
    knobs = dict(
        relay_cap=sc.relay_cap, max_events=sc.max_events,
        horizon=sc.horizon, hz_eps=sc.horizon - T_EPS, t_eps=T_EPS,
        eps=_EPS, ncp=sc.ncp, ns=sc.ns, nj=sc.j, nslot=sc.nslot,
        nseg=sc.j * sc.ne, qcap=sc.qcap, maxch=sc.maxch,
        seq_possible=int(sc.seq_possible), drain=int(sc.drain),
    )
    return tensors, knobs


def _host_apply_due(st: _St, su, sched, ptr, vm_alive, retried, use_edge,
                    qcap, tr):
    """Apply every due scripted event — numpy, the exact reference logic
    (including its Skytrace instants). Returns the new ptr."""
    from .events import RATE_EVENTS, VMFailure

    now = float(st.now)
    names = ("chunk_arr", "remaining", "rate_eff", "conn_alive", "arrived",
             "ready_buf", "q_tail", "relay_occ", "edge_cap")
    h = {k: getattr(st, k).cpu().numpy().copy() for k in names}
    nc = su.conn_job.shape[0]

    def push(sid, ch):
        h["ready_buf"][sid, h["q_tail"][sid] % qcap] = ch
        h["q_tail"][sid] += 1

    applied_t = None
    rate_n = 0
    while ptr < len(sched) and sched[ptr][0] <= now + T_EPS:
        t_ev = sched[ptr][0]
        ev = sched[ptr][2]
        ptr += 1
        applied_t = t_ev
        if isinstance(ev, int):  # job arrival
            h["arrived"][ev] = True
            firsts = su.first_stage[ev]
            for ch in range(int(su.n_chunks[ev])):
                for s0 in firsts[int(su.chunk_path[ev][ch])]:
                    push(s0, ch)
            if tr.enabled:
                tr.instant("sim.arrival", t_ev, job=int(ev),
                           chunks=int(su.n_chunks[ev]))
        elif isinstance(ev, RATE_EVENTS):
            on_edge = np.array(
                [e == (ev.src, ev.dst) for e in su.edges_used], dtype=bool
            )
            hit = on_edge[su.conn_edge]
            h["rate_eff"][:nc][hit] *= ev.factor
            if use_edge:
                h["edge_cap"][on_edge] *= ev.factor
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
                hit = h["conn_alive"][:nc] & (
                    np.isin(su.conn_src, kill)
                    | np.isin(su.conn_dst, kill)
                )
                for ci in np.flatnonzero(hit):
                    if h["chunk_arr"][ci] >= 0:
                        sid = int(su.conn_sid[ci])
                        push(sid, int(h["chunk_arr"][ci]))
                        if su.stage_hop[sid] > 0:
                            h["relay_occ"][sid] += 1
                        retried[su.conn_job[ci]] += 1
                        h["chunk_arr"][ci] = -1
                        h["remaining"][ci] = 0.0
                        requeued += 1
                ca = h["conn_alive"][:nc]
                ca[hit] = False
            if tr.enabled:
                tr.instant("sim.vm_failure", t_ev, job=int(ev.job),
                           region=int(ev.region), killed=len(kill),
                           requeued=requeued)
        else:
            raise TypeError(f"unknown event {ev!r}")
    if applied_t is not None and tr.enabled:
        if rate_n:
            tr.instant("sim.rate_events", applied_t, n=rate_n)
        counts = np.bincount(
            su.conn_edge[h["chunk_arr"][:nc] >= 0],
            minlength=len(su.edges_used),
        )
        for i, (a, b) in enumerate(su.edges_used):
            if counts[i]:
                tr.sample(f"link {a}->{b}", applied_t, int(counts[i]))
    if applied_t is not None:
        for k in names:
            getattr(st, k).copy_(torch.from_numpy(h[k]))
        st.rates_valid.fill_(False)
    st.t_sched.fill_(sched[ptr][0] if ptr < len(sched) else _INF)
    return ptr


def _finalize(st: _St, su, jobs, cfg, retried, tr):
    """Pull the final device state and build MultiSimResult — the exact
    accounting of the reference tail."""
    from .events import JobSimResult, MultiSimResult

    top = su.top
    ne = len(su.edges_used)
    now = float(st.now)
    nc = su.conn_job.shape[0]

    def host(x):
        return x.cpu().numpy()

    chunk_arr = host(st.chunk_arr)[:nc]
    arrived = host(st.arrived)
    finished = host(st.finished)
    finish_t = host(st.finish)
    delivered = host(st.delivered)
    job_edge_gbit = host(st.jeg)
    job_edge_obs_gbit = host(st.jeo)
    job_edge_busy = host(st.jeb)
    _solves.inc(int(st.solves))
    horizon_s = cfg.horizon_s

    horizon_cut = horizon_s is not None and now >= horizon_s - T_EPS
    out = []
    for j, job in enumerate(jobs):
        end = float(finish_t[j]) if finished[j] else now
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
        if finished[j]:
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
    return MultiSimResult(jobs=out, time_s=now, events=int(st.events))


def simulate_multi_torch(
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
    device=None,
    rate_solver: str = "f64",
    block: int = 64,
):
    """Device-resident multi-job simulation (``SimConfig`` knobs and
    ``events`` scenarios identical to the reference engines). ``device``
    None means the card. ``rate_solver`` "f64" is the parity solver,
    "f32" the TPU kernel's counterpart. ``block`` is the number of
    iterations between host reads of the loop flags (on the card, the
    length of the CUDA graph replayed between them); the result does not
    depend on it. Prefer ``transfer.sim.simulate``."""
    cfg = resolve_sim_config(
        config, link_capacity_scale=link_capacity_scale,
        straggler_prob=straggler_prob, straggler_speed=straggler_speed,
        relay_buffer_chunks=relay_buffer_chunks, seed=seed,
        horizon_s=horizon_s, exec_top=exec_top, drain=drain,
    )
    if rate_solver not in RATE_SOLVERS:
        raise ValueError(f"unknown rate solver {rate_solver!r}")
    if block < 1:
        raise ValueError("block must be >= 1")
    dev = resolve_device(device)
    call = next(_call_ids)
    with host_span("sim.call", call=call):
        return _simulate(jobs, faults, cfg, dev, rate_solver, block, call)


def _simulate(jobs, faults, cfg, dev, rate_solver, block, call):
    """``simulate_multi_torch``'s run, inside its ``sim.call`` span."""
    from .events import materialize_jobs, sorted_schedule

    with host_span("sim.build", call=call):
        su = materialize_jobs(
            jobs, seed=cfg.seed, straggler_prob=cfg.straggler_prob,
            straggler_speed=cfg.straggler_speed, exec_top=cfg.exec_top,
        )
        sched = sorted_schedule(jobs, faults)
        tr = get_tracer()
        if tr.enabled:
            tr.instant("sim.start", 0.0, jobs=len(jobs),
                       scheduled=len(sched))
        retried = np.zeros(len(jobs), dtype=np.int64)
        vm_alive = np.ones(su.vm_eg_cap.shape[0], dtype=bool)
        sc, cn, st = _build(su, cfg, sched, rate_solver, dev)
        blocks = _Blocks(st, cn, sc, call)
    ptr = 0
    while True:
        if not bool(st.draining):
            with host_span("sim.apply_due", call=call):
                ptr = _host_apply_due(
                    st, su, sched, ptr, vm_alive, retried,
                    cfg.link_capacity_scale is not None, sc.qcap, tr,
                )
        _segment(st, cn, sc, block, blocks)
        n_td = int(st.td_n)
        if n_td and tr.enabled:
            td_time = st.td_time.cpu().numpy()
            td_job = st.td_job.cpu().numpy()
            for i in range(n_td):
                tr.instant("sim.job_done", float(td_time[i]),
                           job=int(td_job[i]))
        if n_td:
            st.td_n.zero_()
        if bool(st.stop) or int(st.it) >= sc.max_events:
            break
        due = not bool(st.draining) and ptr < len(sched) and (
            sched[ptr][0] <= float(st.now) + T_EPS
        )
        if not due:
            break
    with host_span("sim.finalize", call=call):
        return _finalize(st, su, jobs, cfg, retried, tr)
