"""The port's three sim engines against the reference package's engines.

Every multi-job scenario of the reference's engine tests
(``test_sim_engines.py``, ``test_multijob.py``, ``test_multicast.py``,
``test_event_dispatch.py`` and the sim cases of ``test_chaos.py``) is
built with the reference, carried across with ``repro_torch.convert`` and
run through the port's ``simulate`` on ``engine="ref"``, ``"soa"`` and
``"torch"`` (on ``device="cpu"``). The pins are equality, not a
tolerance:

  * the port's ``soa`` and ``torch`` equal the reference's ``soa``, and
    the port's ``ref`` equals the reference's ``ref``: the run's time and
    event count and every field of every ``JobSimResult``
    (``dataclasses.asdict``);
  * the Skytrace stream of each of the port's engines equals the
    reference's, tuple for tuple.

The single-job sims of ``test_flowsim.py`` (``simulate_transfer`` and the
oracle ``simulate_transfer_reference``, but for the oracle on the
overlay plan) and ``execute_plan`` are held the same way. The
reference's ``soa`` and ``ref`` are numpy and need no x64 shim.
"""

from __future__ import annotations

import dataclasses
import types

import pytest

from repro.core import Planner, PlanSpec, default_topology, direct_plan
from repro.obs import trace as ref_trace
from repro.transfer import (
    ChaosScenario,
    GrayFailure,
    LinkDegrade,
    LinkRestore,
    TransferJob,
    VMFailure,
    execute_plan,
    simulate_transfer,
    simulate_transfer_reference,
)
from repro.transfer import simulate as ref_simulate
from repro.transfer.events import RATE_EVENTS
from repro_torch import convert
from repro_torch.obs import trace as port_trace
from repro_torch.transfer import execute_plan as port_execute_plan
from repro_torch.transfer import simulate as port_simulate
from repro_torch.transfer import simulate_transfer as port_transfer
from repro_torch.transfer import (
    simulate_transfer_reference as port_transfer_reference,
)

from test_torch_sim import SCENARIOS as ENGINE_SCENARIOS
from test_torch_sim import _scenario as engine_scenario

SRC, DST = "aws:us-west-2", "aws:eu-central-1"
SRC2 = "gcp:us-central1"
MC_SRC = "gcp:us-central1"
MC_DSTS = ("gcp:europe-west1", "gcp:europe-west3", "gcp:europe-west4")
OVERLAY = ("azure:canadacentral", "gcp:asia-northeast1")
# which reference engine each of the port's engines is held against
PAIRS = (("soa", "soa"), ("ref", "ref"), ("torch", "soa"))


@pytest.fixture(scope="module")
def ctx():
    """The reference's topology and the plans the scenarios share."""
    top = default_topology()
    planner = Planner(top, max_relays=6)

    def mc(goal, volume):
        plan = planner.plan(PlanSpec(
            objective="cost_min", src=MC_SRC, dsts=MC_DSTS,
            tput_goal_gbps=goal, volume_gb=volume,
        ))
        assert plan.solver_status == "optimal"
        return plan

    return types.SimpleNamespace(
        top=top, mc=mc(2.0, 4.0), mc_unequal=mc([0.5, 2.0, 2.0], 1.0),
    )


@pytest.fixture(scope="module")
def overlay_plan(ctx):
    """test_flowsim's overlay plan: tput_max on a 4-VM budget."""
    small = dataclasses.replace(ctx.top, limit_vm=4)
    dp = direct_plan(small, *OVERLAY, 16.0, num_vms=4)
    return Planner(small).plan(PlanSpec(
        objective="tput_max", src=OVERLAY[0], dst=OVERLAY[1],
        cost_ceiling_per_gb=dp.cost_per_gb * 1.3, volume_gb=16.0,
        n_samples=8,
    ))


# ------------------------------------------------------------- scenarios
def _jobs(top, volume=2.0, arrivals=(0.0, 1.0, 0.5)):
    """test_multijob's (and test_chaos's) three tenants."""
    return [
        TransferJob(direct_plan(top, SRC, DST, volume, num_vms=2), "a",
                    arrival_s=arrivals[0]),
        TransferJob(direct_plan(top, SRC, DST, volume, num_vms=2), "b",
                    arrival_s=arrivals[1]),
        TransferJob(direct_plan(top, SRC2, DST, volume, num_vms=2), "c",
                    arrival_s=arrivals[2]),
    ]


def _faults(top):
    s, d = top.index(SRC), top.index(DST)
    return [LinkDegrade(t_s=2.0, src=s, dst=d, factor=0.5),
            VMFailure(t_s=3.0, job=0, region=s, count=1)]


def _one_job(top, arrival_s=0.0):
    return [TransferJob(direct_plan(top, SRC, DST, 1.0, num_vms=2), "a",
                        arrival_s=arrival_s)]


def _kill_fault(plan):
    d = next(int(d) for d in plan.dsts if plan.N[d] >= 1)
    return VMFailure(t_s=1.5, job=0, region=d, count=1)


def _chaos_faults(top):
    s, d, s2 = top.index(SRC), top.index(DST), top.index(SRC2)
    return [
        GrayFailure(t_s=0.5, src=s, dst=d, factor=0.3),
        LinkDegrade(t_s=1.0, src=s, dst=d, factor=0.5),
        LinkRestore(t_s=2.0, src=s, dst=d, factor=2.0),
        GrayFailure(t_s=2.5, src=s, dst=d, factor=1.0 / 0.3),
        LinkDegrade(t_s=3.0, src=s2, dst=d, factor=0.1),
        LinkRestore(t_s=4.0, src=s2, dst=d, factor=10.0),
    ]


def _chaos_suite(top, seed):
    s, d, s2 = top.index(SRC), top.index(DST), top.index(SRC2)
    sc = ChaosScenario(top, seed=seed, horizon_s=8.0, n_region_outages=1,
                       n_brownouts=1, n_gray=1, n_flapping=1,
                       links=[(s, d), (s2, d)])
    return sc.events(3)


def _multi_scenario(name, c):
    """(jobs, faults, sim kwargs) of each multi-job scenario, by the
    reference test it comes from."""
    top, s, d = c.top, c.top.index(SRC), c.top.index(DST)
    kind, _, arg = name.partition(":")
    if kind == "engines":
        jobs, faults, kw = engine_scenario(arg, top)
        return jobs, faults, {"seed": 0, **kw}
    if kind == "multijob":
        seed, faulted = {"clean": (0, False), "faults": (0, True),
                         "faults_seed3": (3, True)}[arg]
        return _jobs(top), _faults(top) if faulted else [], {"seed": seed}
    if kind == "multijob_horizon":
        return _jobs(top), _faults(top), {"seed": 1, "horizon_s": 4.0}
    if kind == "multijob_delayed":
        return _jobs(top, arrivals=(0.0, 4.0, 0.0)), [], {"seed": 0}
    if kind == "multijob_contention":
        n = 1 if arg == "solo" else 2
        jobs = [TransferJob(direct_plan(top, SRC, DST, 2.0, num_vms=2),
                            f"j{i}") for i in range(n)]
        return jobs, [], {"seed": 0, "link_capacity_scale": 0.4}
    if kind == "multijob_degrade":
        jobs = [TransferJob(direct_plan(top, SRC, DST, 2.0, num_vms=2), "a")]
        faults = [LinkDegrade(t_s=1.0, src=s, dst=d, factor=0.25)]
        return jobs, faults if arg == "degraded" else [], {"seed": 2}
    if kind == "multijob_total_kill":
        return _jobs(top), [VMFailure(t_s=1.0, job=0, region=s, count=2)], \
            {"seed": 0}
    if kind == "multicast_kill":
        return [TransferJob(c.mc, "repl")], [_kill_fault(c.mc)], \
            {"seed": int(arg)}
    if kind == "multicast_clean":
        return [TransferJob(c.mc, "repl")], [], {"seed": 0}
    if kind == "multicast_unequal":
        return [TransferJob(c.mc_unequal, "mc")], [], {"seed": 0}
    if kind == "multicast_shared_plane":
        jobs = [TransferJob(c.mc, "mc"),
                TransferJob(direct_plan(top, SRC, DST, 2.0, num_vms=2),
                            "uni", arrival_s=0.5)]
        return jobs, [], {"seed": 1}
    if kind == "multicast_at_horizon":
        mc_s, d0 = top.index(MC_SRC), int(c.mc.dsts[0])
        if arg == "event":
            faults = [LinkDegrade(t_s=2.0, src=mc_s, dst=d0, factor=0.5)]
            return [TransferJob(c.mc, "repl")], faults, \
                {"seed": 0, "horizon_s": 2.0}
        return [TransferJob(c.mc, "late", arrival_s=2.0)], [], \
            {"seed": 0, "horizon_s": 2.0}
    if kind == "event_class":
        cls = {c_.__name__: c_ for c_ in RATE_EVENTS}.get(arg)
        faults = ([VMFailure(t_s=1.0, job=0, region=s, count=1)]
                  if cls is None else [cls(t_s=1.0, src=s, dst=d, factor=0.5)])
        return _one_job(top), faults, {"seed": 0}
    if kind == "event_delayed_arrival":
        return _one_job(top, arrival_s=1.5), [], {"seed": 0}
    if kind == "chaos_events":
        return _jobs(top), _chaos_faults(top), {"seed": int(arg)}
    if kind == "chaos_suite":
        return _jobs(top), _chaos_suite(top, int(arg)), {"seed": int(arg)}
    raise KeyError(name)


MULTI_SCENARIOS = (
    [f"engines:{n}" for n in ENGINE_SCENARIOS]
    + ["multijob:clean", "multijob:faults", "multijob:faults_seed3",
       "multijob_horizon", "multijob_delayed", "multijob_contention:solo",
       "multijob_contention:pair", "multijob_degrade:clean",
       "multijob_degrade:degraded", "multijob_total_kill",
       "multicast_kill:0", "multicast_kill:3", "multicast_clean",
       "multicast_unequal", "multicast_shared_plane",
       "multicast_at_horizon:event", "multicast_at_horizon:arrival"]
    + [f"event_class:{c.__name__}" for c in RATE_EVENTS]
    + ["event_class:VMFailure", "event_delayed_arrival",
       "chaos_events:0", "chaos_events:3", "chaos_suite:5", "chaos_suite:11"]
)


# ------------------------------------------------------------------- runs
def _run_ref(jobs, faults, engine, kw):
    tr = ref_trace.enable(capacity=1 << 16)
    try:
        return ref_simulate(jobs, faults, engine=engine, **kw), tr.events()
    finally:
        ref_trace.disable()


def _run_port(jobs, faults, engine, kw):
    tr = port_trace.enable(capacity=1 << 16)
    try:
        res = port_simulate(jobs, faults, engine=engine, device="cpu", **kw)
        return res, tr.events()
    finally:
        port_trace.disable()


def _assert_equal(got, want):
    assert got.time_s == want.time_s
    assert got.events == want.events
    assert len(got.jobs) == len(want.jobs)
    for a, b in zip(got.jobs, want.jobs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("name", MULTI_SCENARIOS)
def test_port_engines_equal_reference_engines(name, ctx):
    jobs, faults, kw = _multi_scenario(name, ctx)
    pjobs, pfaults = convert.to_port_jobs(jobs), convert.to_port_faults(faults)
    want = {e: _run_ref(jobs, faults, e, kw) for e in ("soa", "ref")}
    for port_engine, ref_engine in PAIRS:
        got, got_tr = _run_port(pjobs, pfaults, port_engine, kw)
        _assert_equal(got, want[ref_engine][0])
        assert got_tr == want[ref_engine][1], port_engine
    assert want["soa"][1] == want["ref"][1]
    assert len(want["soa"][1]) >= 2


def test_scenarios_exercise_their_paths(ctx):
    """The properties the reference's tests assert of these scenarios hold
    on the port's engines too, so the equalities above are not vacuous."""
    def run(name, engine="soa"):
        jobs, faults, kw = _multi_scenario(name, ctx)
        return _run_port(convert.to_port_jobs(jobs),
                         convert.to_port_faults(faults), engine, kw)[0]

    kill = run("multijob:faults", "ref")
    assert all(j.status == "done" for j in kill.jobs)
    assert kill.jobs[0].retried_chunks > 0
    stalled = run("multijob_total_kill", "torch")
    assert [j.status for j in stalled.jobs] == ["stalled", "done", "done"]
    cut = run("multijob_horizon")
    assert any(j.status == "running" for j in cut.jobs)
    assert cut.time_s == pytest.approx(4.0)
    solo, pair = run("multijob_contention:solo"), run("multijob_contention:pair")
    assert all(j.tput_gbps < solo.jobs[0].tput_gbps * 0.75 for j in pair.jobs)
    mc = run("multicast_kill:0", "torch").jobs[0]
    assert mc.retried_chunks > 0 and set(mc.per_dst_delivered) == set(
        int(d) for d in ctx.mc.dsts)
    assert run("event_delayed_arrival", "ref").time_s > 1.5


# ----------------------------------------------------------- single job
SINGLE = [
    ("dynamic", 0, 4.0, 16, 2), ("dynamic", 3, 4.0, 16, 2),
    ("static", 0, 4.0, 16, 2), ("static", 0, 0.5, 256, 2),
    ("dynamic", 0, 0.5, 256, 2), ("dynamic", 0, 4.0, 16, 1),
]


def _single_plan(case, ctx, request):
    if case == "overlay":
        return request.getfixturevalue("overlay_plan"), \
            {"seed": 1, "chunk_mb": 16}
    dispatch, seed, volume, chunk_mb, vms = case
    plan = direct_plan(ctx.top, SRC, DST, volume, num_vms=vms)
    return plan, {"seed": seed, "chunk_mb": chunk_mb, "dispatch": dispatch}


@pytest.mark.parametrize("case", SINGLE + ["overlay"], ids=str)
def test_single_job_sims_equal_reference(case, ctx, request):
    """``simulate_transfer`` and the oracle ``simulate_transfer_reference``
    equal the reference's in every ``SimResult`` field, and
    ``execute_plan`` in its report."""
    plan, kw = _single_plan(case, ctx, request)
    pplan = convert.to_port_plan(plan)
    pairs = [(port_transfer, simulate_transfer)]
    if case != "overlay":  # the oracle takes ~22 s a run on the overlay
        pairs.append((port_transfer_reference, simulate_transfer_reference))
    for port_fn, ref_fn in pairs:
        assert dataclasses.asdict(port_fn(pplan, **kw)) == \
            dataclasses.asdict(ref_fn(plan, **kw))
    assert port_execute_plan(pplan, **kw).to_dict() == \
        execute_plan(plan, **kw).to_dict()


def test_straggler_free_single_job_equals_reference(ctx):
    plan = direct_plan(ctx.top, SRC, DST, 8.0, num_vms=2)
    kw = {"seed": 0, "chunk_mb": 16, "straggler_prob": 0.0}
    got = port_transfer(convert.to_port_plan(plan), **kw)
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(simulate_transfer(plan, **kw))
    assert got.tput_gbps >= plan.throughput * 0.7


def test_engine_names_and_device_rule():
    """The port registers the reference's two numpy engines beside its own;
    ``device`` reaches only the torch engine."""
    from repro_torch.transfer.simconfig import ENGINE_NAMES, SimConfig

    assert ENGINE_NAMES == ("ref", "soa", "torch")
    assert SimConfig().engine == "torch"
    top = default_topology()
    jobs = convert.to_port_jobs(_one_job(top))
    for engine in ("ref", "soa"):  # numpy: an unknown device is not read
        res = port_simulate(jobs, engine=engine, device="no-such-device")
        assert res.jobs[0].status == "done"
