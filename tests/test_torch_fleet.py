"""The port's fleet controller (``transfer/fleet.py``) against the
reference package's.

``weighted_max_min`` is held bitwise on seeded demands and weights, the
validation of ``TenantSpec``, ``FleetController`` and ``submit`` by its
errors, and every scenario of the reference's fleet tests — admission
(headroom boost, deferral, deadline first), the fair shares, VM quotas
and their borrowing, the rotating probe focus, the probe dedup, the
cohort admission with its structure builds, and the end-to-end run —
by what it decides, under the two planning pairings of
``test_torch_calibrate.py`` (numpy on both sides, EQUAL; the port's
torch IPM against the reference's jax IPM, floats within
``TORCH_JAX_RTOL``). Runs that simulate go through the port's ``soa``
and ``torch`` engines (``device="cpu"``). The fleet benchmark's world
(``benchmarks/fleet_bench.py``) at its FAST size, its fleet arm, is held
under the numpy pairing.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

import repro.calibrate as ref_cal
import repro.core as ref_core
import repro.transfer as ref_transfer
import repro_torch.calibrate as port_cal
import repro_torch.core as port_core
import repro_torch.transfer as port_transfer
from repro.transfer import fleet as ref_fleet
from repro_torch.transfer import fleet as port_fleet
from test_torch_calibrate import _api, compare_runs
from test_torch_executor import (  # noqa: F401  (x64_shim is a fixture)
    TORCH_JAX_RTOL,
    assert_same,
    x64_shim,
)
from test_torch_cases import one_thread  # noqa: F401

SRC, DST = "aws:us-west-2", "aws:eu-central-1"
SRC2 = "azure:canadacentral"
SVC_KW = dict(max_relays=6, check_interval_s=8.0, max_segments=40)


@pytest.fixture(scope="module")
def tops():
    return {"ref": ref_core.default_topology(),
            "port": port_core.default_topology()}


# ------------------------------------------------------- weighted max-min
WMM_FIXED = [
    ([1.0, 1.0], [1.0, 10.0], 6.0),
    ([1.0, 3.0], [10.0, 10.0], 8.0),
    ([2.0, 1.0, 1.0], [5.0, 5.0, 5.0], 8.0),
    ([1.0, 1.0], [0.0, 4.0], 10.0),
]


def _wmm_case(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    weights = rng.uniform(0.1, 4.0, n).tolist()
    demands = np.where(rng.random(n) < 0.2, 0.0,
                       rng.uniform(0.0, 10.0, n)).tolist()
    capacity = float(rng.uniform(0.0, 1.3) * sum(demands))
    return weights, demands, capacity


@pytest.mark.parametrize("case", [*range(4), *(f"seed{s}" for s in range(8))])
def test_weighted_max_min_equals_reference(case):
    w, d, c = (WMM_FIXED[case] if isinstance(case, int)
               else _wmm_case(int(case[4:])))
    got = port_fleet.weighted_max_min(list(w), list(d), c)
    assert got == ref_fleet.weighted_max_min(list(w), list(d), c)
    assert sum(got) <= c + 1e-9 and all(
        a <= b + 1e-9 for a, b in zip(got, d))


# ------------------------------------------------------------- validation
def _drift(cal, top):
    return cal.DriftModel(top, seed=0, drift_sigma=0.0, diurnal_amp=0.0)


def _error(fn):
    with pytest.raises((ValueError, KeyError)) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def _validation_errors(cal, tr, top):
    kw = dict(SVC_KW, backend="numpy")
    if tr is port_transfer:
        kw.update(device="cpu", engine="soa")
    fleet = tr.FleetController(_drift(cal, top), tenants=[
        tr.TenantSpec("a"), tr.TenantSpec("b")], **kw)
    req = functools.partial(tr.TransferRequest, "j0", SRC, DST, 1.0, 1.0)
    out = [
        _error(lambda: tr.TenantSpec("t", slo_class="best-effort")),
        _error(lambda: tr.TenantSpec("t", weight=0.0)),
        _error(lambda: tr.FleetController(_drift(cal, top), tenants=[],
                                          **kw)),
        _error(lambda: tr.FleetController(
            _drift(cal, top), tenants=[tr.TenantSpec("a"),
                                       tr.TenantSpec("a")], **kw)),
        _error(lambda: fleet.submit(req())),
        _error(lambda: fleet.submit(req(), tenant="c")),
    ]
    fleet.submit(req(), tenant="a")
    out.append(_error(lambda: fleet.submit(req(), tenant="b")))
    fleet._queue.append(tr.TransferRequest("stray", SRC, DST, 1.0, 1.0))
    out.append(_error(fleet._admit_queue))
    solo = tr.FleetController(_drift(cal, top), tenants=[
        tr.TenantSpec("only")], **kw)
    solo.submit(req())
    out.append(solo._tenant_of)
    return out


def test_validation_equals_reference(tops):
    got = _validation_errors(port_cal, port_transfer, tops["port"])
    assert got == _validation_errors(ref_cal, ref_transfer, tops["ref"])
    assert [e[0] for e in got[:8]] == ["ValueError"] * 5 + [
        "KeyError", "ValueError", "ValueError"]


# ------------------------------------------------------------- scenarios
def _fleet(api, tenants, **kw):
    return api.tr.FleetController(_drift(api.cal, api.top), tenants=tenants,
                                  **{**SVC_KW, **api.svc, **kw})


def _plan(p) -> dict:
    return {"status": p.solver_status, "N": np.asarray(p.N).tolist(),
            "M": np.asarray(p.M).tolist(), "F": np.asarray(p.F).tolist(),
            "throughput": float(p.throughput),
            "total_cost": float(p.total_cost)}


def _states(states) -> list:
    return [{"name": st.req.name, "status": st.status,
             "goal": st.req.tput_goal_gbps, "arrival_s": st.req.arrival_s,
             "n_chunks": st.n_chunks, "plan": _plan(st.plan)}
            for st in states]


def _fleet_view(fleet) -> dict:
    return {"deferred": dict(fleet._deferred),
            "clamped": sorted(fleet._quota_clamped),
            "borrows": dict(fleet._quota_borrows),
            "shares": {t: s.tolist() for t, s in fleet._tenant_shares.items()}}


def _headroom(api):
    T = api.tr.TenantSpec
    fleet = _fleet(api, [T("a")], headroom_boost=1.5)
    fleet.submit(api.tr.TransferRequest("j0", SRC, DST, 1.0, 1.0))
    states = fleet._admit_queue()
    assert states[0].status == "planned"
    assert states[0].req.tput_goal_gbps == pytest.approx(1.5)
    return {"states": _states(states), "fleet": _fleet_view(fleet)}


def _deferral(api):
    T = api.tr.TenantSpec
    fleet = _fleet(api, [T("a")], admission_margin=0.05, min_admit_frac=0.9,
                   headroom_boost=1.0)
    for name in ("j0", "j1"):
        fleet.submit(api.tr.TransferRequest(name, SRC, DST, 40.0, 4.0))
    states = fleet._admit_queue()
    assert fleet._deferred.get("j1", 0.0) > 0.0
    return {"states": _states(states), "fleet": _fleet_view(fleet)}


def _deadline_first(api):
    T = api.tr.TenantSpec
    fleet = _fleet(api, [T("bulk"), T("dl", slo_class="deadline")],
                   admission_margin=0.3, headroom_boost=1.0)
    fleet.submit(api.tr.TransferRequest("b0", SRC, DST, 40.0, 6.0),
                 tenant="bulk")
    fleet.submit(api.tr.TransferRequest("d0", SRC, DST, 4.0, 6.0,
                                        deadline_s=300.0), tenant="dl")
    goals = fleet._admission(list(fleet._queue))
    assert "d0" not in fleet._deferred
    assert goals["d0"] >= fleet.min_admit_frac * 6.0 - 1e-9
    return {"goals": goals, "fleet": _fleet_view(fleet)}


def _fair_shares(api):
    T = api.tr.TenantSpec
    fleet = _fleet(api, [T("bulk"), T("dl", slo_class="deadline")],
                   headroom_boost=1.0)
    fleet.submit(api.tr.TransferRequest("b0", SRC, DST, 10.0, 8.0),
                 tenant="bulk")
    fleet.submit(api.tr.TransferRequest("d0", SRC, DST, 10.0, 8.0,
                                        deadline_s=300.0), tenant="dl")
    shares = fleet._fair_shares(list(fleet._queue), {"b0": 8.0, "d0": 8.0})
    both = np.isfinite(shares["dl"]) & np.isfinite(shares["bulk"])
    assert both.any()
    assert (shares["dl"][both] >= shares["bulk"][both] - 1e-9).all()
    return {t: s.tolist() for t, s in shares.items()}


def _vm_budget(api):
    out = {}
    for budget in (None, 2):
        svc = api.cal.CalibratedTransferService(
            _drift(api.cal, api.top), vm_budget=budget, **SVC_KW, **api.svc)
        svc.submit(api.tr.TransferRequest("j0", SRC, DST, 8.0, 6.0))
        st = svc._admit_queue()[0]
        out[str(budget)] = {"state": _states([st]),
                            "clamped": sorted(svc._vm_clamped)}
    assert out["2"]["state"][0]["plan"]["status"] == "optimal"
    assert out["2"]["clamped"] == ["j0"]
    return out


def _quota_borrow(api):
    T = api.tr.TenantSpec
    fleet = _fleet(api, [T("a", vm_quota=2), T("b", vm_quota=4)],
                   headroom_boost=1.0)
    fleet.submit(api.tr.TransferRequest("a0", SRC, DST, 4.0, 6.0),
                 tenant="a")
    fleet.submit(api.tr.TransferRequest("b0", SRC2, DST, 4.0, 2.0),
                 tenant="b")
    states = fleet._admit_queue()
    budgets = [fleet._vm_budget_for(states[0].req)]
    for st in states:
        if st.req.name == "b0":
            st.remaining_chunks = 0
    budgets.append(fleet._vm_budget_for(states[0].req))
    assert budgets == [2.0, 6.0] and fleet._quota_borrows["a"] >= 1
    return {"states": _states(states), "budgets": budgets,
            "fleet": _fleet_view(fleet)}


def _quota_admission(api):
    fleet = _fleet(api, [api.tr.TenantSpec("a", vm_quota=2)],
                   headroom_boost=1.0)
    fleet.submit(api.tr.TransferRequest("a0", SRC, DST, 8.0, 6.0),
                 tenant="a")
    states = fleet._admit_queue()
    assert states[0].plan.num_vms <= 2 and "a0" in fleet._quota_clamped
    return {"states": _states(states), "fleet": _fleet_view(fleet)}


def _probe_focus(api):
    T = api.tr.TenantSpec
    fleet = _fleet(api, [T("a"), T("b")], headroom_boost=1.0)
    fleet.submit(api.tr.TransferRequest("a0", SRC, DST, 2.0, 1.0),
                 tenant="a")
    fleet.submit(api.tr.TransferRequest("b0", SRC2, DST, 2.0, 1.0),
                 tenant="b")
    states = fleet._admit_queue()
    act = list(range(len(states)))
    turns = [fleet._probe_focus(states, act) for _ in range(3)]
    ctxs = [c for c, _ in turns]
    assert ctxs[0] != ctxs[1] and ctxs[2] == ctxs[0]
    return {"contexts": ctxs,
            "plans": [[_plan(p) for p in plans] for _, plans in turns]}


def _probe_dedup(api):
    cal, top = api.cal, api.top
    planner = api.core.Planner(top, max_relays=6)
    n_cand = len(cal.Calibrator(cal.BeliefGrid(top)).candidate_links(
        planner, [(SRC, DST)]))
    calr = cal.Calibrator(
        cal.BeliefGrid(top), dedup_window_s=60.0,
        budget=cal.ProbeBudget(usd_per_round=1e9, seconds_per_round=30.0,
                               max_probes_per_round=n_cand))
    truth = _drift(cal, top).tput_at(0.0)
    rounds = [calr.run_round(t, truth, planner=planner,
                             contexts=[(SRC, DST)]) for t in (0.0, 1.0)]
    link = (rounds[0].records[0].src, rounds[0].records[0].dst)
    rounds.append(calr.run_round(2.0, truth, links=[link]))
    assert rounds[1].n_probes == 0 and rounds[1].deduped >= rounds[0].n_probes
    assert (rounds[2].n_probes, rounds[2].deduped) == (1, 0)
    return [dataclasses.asdict(r) for r in rounds]


def _cohort(api):
    planner = api.core.Planner(api.top, max_relays=6,
                               **({"device": "cpu"}
                                  if api.tr is port_transfer else {}))
    specs = [api.core.PlanSpec(objective="cost_min", src=SRC, dst=DST,
                               tput_goal_gbps=g, volume_gb=2.0,
                               backend=api.svc["backend"])
             for g in (1.0, 2.0, 3.0)]
    batched = [_plan(p) for p in planner.plan_cohort(specs)]
    solo = [_plan(planner.plan(sp)) for sp in specs]
    for b, s in zip(batched, solo):
        assert b["status"] == s["status"] == "optimal"
        assert b["throughput"] == pytest.approx(s["throughput"])
    return {"batched": batched, "solo": solo}


def _cohort_builds(api):
    fleet = _fleet(api, [api.tr.TenantSpec("a")], headroom_boost=1.0)
    for i in range(3):
        fleet.submit(api.tr.TransferRequest(f"j{i}", SRC, DST, 2.0, 1.0),
                     tenant="a")
    b0 = api.core.milp.N_STRUCT_BUILDS
    states = fleet._admit_queue()
    builds = api.core.milp.N_STRUCT_BUILDS - b0
    assert builds <= 1 and all(s.status == "planned" for s in states)
    return {"states": _states(states), "builds": builds}


DECISIONS = {
    "headroom_boost": _headroom,
    "deferral": _deferral,
    "deadline_first": _deadline_first,
    "fair_shares": _fair_shares,
    "vm_budget": _vm_budget,
    "quota_borrow": _quota_borrow,
    "quota_admission": _quota_admission,
    "probe_focus": _probe_focus,
    "probe_dedup": _probe_dedup,
    "cohort": _cohort,
    "cohort_builds": _cohort_builds,
}


def _compare_decision(name, pairing, tops):
    want = DECISIONS[name](_api("ref", pairing, None, tops))
    got = DECISIONS[name](_api("port", pairing, None, tops))
    assert_same(got, want, 0.0 if pairing == "numpy" else TORCH_JAX_RTOL)


@pytest.mark.parametrize("name", sorted(DECISIONS))
def test_fleet_decisions_equal_reference_numpy_planner(name, tops):
    _compare_decision(name, "numpy", tops)


@pytest.mark.parametrize("name", sorted(DECISIONS))
def test_fleet_decisions_equal_reference_batched_ipm(name, tops, x64_shim):
    _compare_decision(name, "torch", tops)


# ------------------------------------------------------------ end to end
def _end_to_end(api):
    """test_fleet's two-tenant run in a drift-free world."""
    T = api.tr.TenantSpec
    fleet = _fleet(api, [T("a", vm_quota=8),
                         T("dl", weight=2.0, slo_class="deadline")])
    fleet.submit(api.tr.TransferRequest("a0", SRC, DST, 2.0, 2.0,
                                        chunk_mb=4.0), tenant="a")
    fleet.submit(api.tr.TransferRequest("d0", SRC2, DST, 2.0, 2.0,
                                        chunk_mb=4.0, deadline_s=120.0),
                 tenant="dl")
    return [(fleet, fleet.run())]


def _bench_world(api):
    """``benchmarks/fleet_bench.py``'s world at its FAST size: three
    tenants of two jobs each (2-6 GB in 1 MB chunks, all at 0 s), a
    4-VM quota each, an incident at 6 s on the busiest planned edge."""
    top, cal, tr = api.top, api.cal, api.tr
    probe = api.core.Planner(top, max_relays=6).plan(api.core.PlanSpec(
        objective="cost_min", src=SRC, dst=DST, tput_goal_gbps=4.0,
        volume_gb=4.0))
    a, b = np.unravel_index(int(np.argmax(probe.F)), probe.F.shape)

    def drift():
        return cal.DriftModel(top, seed=0, drift_sigma=0.10, diurnal_amp=0.0,
                              incidents=[cal.Incident(
                                  src=int(a), dst=int(b), t_start_s=6.0,
                                  duration_s=1e9, severity=0.08)])

    tenants = [tr.TenantSpec("analytics", weight=1.0, vm_quota=4),
               tr.TenantSpec("backup", weight=1.0, vm_quota=4),
               tr.TenantSpec("ml-sync", weight=2.0, slo_class="deadline",
                             vm_quota=4)]
    sizes = (2.0, 4.0, 3.0, 6.0)
    jobs = {}
    for ti, spec in enumerate(tenants):
        src = SRC2 if spec.name == "backup" else SRC
        jobs[spec.name] = [
            dict(name=f"{spec.name}-{j}", src=src, dst=DST,
                 volume_gb=sizes[(ti + j) % 4], tput_goal_gbps=2.0,
                 chunk_mb=1.0,
                 deadline_s=(sizes[(ti + j) % 4] * 4.0 + 30.0
                             if spec.slo_class == "deadline" else None))
            for j in range(2)]
    return drift, tenants, jobs


def _bench(api):
    """The benchmark's fleet arm (its isolated arms are calibrated
    services, held in ``test_torch_calibrate.py``)."""
    drift, tenants, jobs = _bench_world(api)
    fleet = api.tr.FleetController(
        drift(), tenants=tenants, probe_dedup_window_s=3.0, max_relays=6,
        check_interval_s=4.0, max_segments=150, **api.svc)
    for spec in tenants:
        for j in jobs[spec.name]:
            fleet.submit(api.tr.TransferRequest(**j), tenant=spec.name)
    return [(fleet, fleet.run())]


@pytest.mark.parametrize("pairing", ["numpy", "torch"])
def test_fleet_run_equals_reference(pairing, tops, request):
    if pairing == "torch":
        request.getfixturevalue("x64_shim")
    runs = compare_runs(_end_to_end, pairing, tops)
    [(_, rep)] = runs
    assert isinstance(rep, port_transfer.FleetReport)
    assert sum(j.delivered_gb for j in rep.jobs) == pytest.approx(4.0)
    assert sum(r.structure_builds for j in rep.jobs for r in j.replans) == 0
    d = rep.to_dict()
    assert d["kind"] == "fleet" and d["tenants_n"] == 2
    assert {t["name"] for t in d["tenants"]} == {"a", "dl"}
    dl = next(t for t in rep.tenants if t.name == "dl")
    assert isinstance(dl, port_transfer.TenantReport)
    assert dl.deadline_misses == 0
    assert "[fleet]" in rep.summary() and "[tenant]" in dl.summary()


def test_fleet_bench_world_equals_reference(tops):
    [(_, rep)] = compare_runs(_bench, "numpy", tops)
    assert len(rep.jobs) == 6 and all(j.status == "done" and
                                      j.lost_chunks == 0 for j in rep.jobs)
    assert rep.drift_events and rep.probe_rounds
    assert sum(r.structure_builds for j in rep.jobs for r in j.replans) == 0
    assert sum(t.deadline_misses for t in rep.tenants) == 0
