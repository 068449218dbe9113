"""The port's calibration plane against the reference package's.

Every module of ``calibrate/`` is a copy of the reference's, so each is
held equal on the same seeded inputs:

  * ``DriftModel``: ``factor_at``, ``tput_at`` and ``topology_at`` at
    several times, with scripted and with random incidents, bitwise;
  * ``BeliefGrid``: the update sequences of the reference's calibration
    tests (``observe``, ``observe_adaptive`` with its change-point reset,
    ``scale_grid``, ``reset_link``, ``observe_link_rates`` fed from the
    port's gateway), its statistics bitwise;
  * the four probe policies, one probe round after another under one
    budget: the same links at the same costs;
  * the sim path the calibrated service is the first to use: each segment
    on the true topology (``exec_top``) with ``drain=True``, on the port's
    ``soa`` and ``torch`` engines against the reference's ``soa``, every
    field of every ``JobSimResult`` (the per-edge telemetry maps the
    service harvests included);
  * ``CalibratedTransferService`` on every service scenario of the
    reference's calibration and probe-policy tests, at their own sizes,
    under the two planning pairings of ``test_torch_executor.py``:
    ``backend="numpy"`` on both sides, held EQUAL, and the port's torch
    IPM against the reference's jax IPM (x64 shim), integers and strings
    equal and floats within ``TORCH_JAX_RTOL``. The port runs each on
    ``engine="soa"`` and ``engine="torch"`` (``device="cpu"``); the record
    is ``chip_smoke.service_record``, which for a calibrated run adds every
    probe round, drift event and epoch roll, the belief-error trajectory,
    the segment boundaries and the final belief.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

import repro.calibrate as ref_cal
import repro.core as ref_core
import repro.transfer as ref_transfer
import repro_torch.calibrate as port_cal
import repro_torch.core as port_core
import repro_torch.transfer as port_transfer
from repro.transfer import simulate as ref_simulate
from repro_torch import convert
from test_torch_executor import (  # noqa: F401  (x64_shim is a fixture)
    TORCH_JAX_RTOL,
    assert_same,
    service_record,
    x64_shim,
)
from test_torch_cases import one_thread  # noqa: F401

SRC, DST = "aws:us-west-2", "aws:eu-central-1"
MC_SRC, MC_DSTS = "gcp:us-central1", ["gcp:europe-west1", "gcp:europe-west3"]


@pytest.fixture(scope="module")
def tops():
    return {"ref": ref_core.default_topology(),
            "port": port_core.default_topology()}


def _api(side, pairing, engine, tops):
    """One package's names, and the service keywords of this pairing."""
    if side == "ref":
        return types.SimpleNamespace(
            cal=ref_cal, core=ref_core, tr=ref_transfer, top=tops["ref"],
            svc={"backend": "numpy" if pairing == "numpy" else "jax"},
        )
    return types.SimpleNamespace(
        cal=port_cal, core=port_core, tr=port_transfer, top=tops["port"],
        svc={"backend": "numpy" if pairing == "numpy" else "torch",
             "device": "cpu", "engine": engine},
    )


# ------------------------------------------------------------------ drift
DRIFT_CASES = {
    "scripted": dict(seed=0, drift_sigma=0.10, diurnal_amp=0.0,
                     incident=True),
    "random_incidents": dict(seed=7, n_incidents=3),
    "diurnal": dict(seed=3, drift_sigma=0.3, diurnal_amp=0.2, day_s=60.0),
    "clipped": dict(seed=1, drift_sigma=0.4),
}
DRIFT_TIMES = (0.0, 5.999, 6.0, 13.25, 500.0, 1e4, 123456.789)


def _drift(cal, top, case):
    kw = dict(DRIFT_CASES[case])
    if kw.pop("incident", False):
        s, d = top.index(SRC), top.index(DST)
        kw["incidents"] = [cal.Incident(src=s, dst=d, t_start_s=6.0,
                                        duration_s=1e9, severity=0.08)]
    return cal.DriftModel(top, **kw)


@pytest.mark.parametrize("case", sorted(DRIFT_CASES))
def test_drift_model_equals_reference(case, tops):
    want = _drift(ref_cal, tops["ref"], case)
    got = _drift(port_cal, tops["port"], case)
    assert [dataclasses.asdict(i) for i in got.incidents] == \
        [dataclasses.asdict(i) for i in want.incidents]
    for t in DRIFT_TIMES:
        assert np.array_equal(got.factor_at(t), want.factor_at(t))
        assert np.array_equal(got.tput_at(t), want.tput_at(t))
        assert convert.topology_state(got.topology_at(t)).keys() == \
            convert.topology_state(want.topology_at(t)).keys()
        for k, v in convert.topology_state(want.topology_at(t)).items():
            g = convert.topology_state(got.topology_at(t))[k]
            assert np.array_equal(np.asarray(g), np.asarray(v)), (t, k)
        assert [dataclasses.asdict(i) for i in got.incidents_active(t)] == \
            [dataclasses.asdict(i) for i in want.incidents_active(t)]
    s, d = tops["ref"].index(SRC), tops["ref"].index(DST)
    assert got.link_gbps(s, d, 7.5) == want.link_gbps(s, d, 7.5)


# ----------------------------------------------------------------- belief
def _belief_state(bel) -> dict:
    return {"mean": bel.mean.tolist(), "count": bel.count.tolist(),
            "m2": bel.m2.tolist(), "last_obs_t": bel.last_obs_t.tolist(),
            "version": bel.version, "epoch": bel.epoch,
            "observations": bel.observations,
            "stderr": bel.stderr().tolist(),
            "lower_bound": bel.lower_bound(1.5).tolist()}


def _gateway_rates():
    """Per-edge rates from the port's gateway (test_calibration's toy
    transfer): the sample both beliefs fold in."""
    top = port_core.toy_topology(n=5, seed=2)
    plan = port_core.Planner(top, max_relays=3).plan_cost_min(
        "toy:r0", "toy:r1", 2.0, 0.02)
    src, dst = port_transfer.BlobStore(), port_transfer.BlobStore()
    src.put("obj", np.random.default_rng(0).bytes(1_500_000))
    rep = port_transfer.transfer_objects(plan, src, dst, ["obj"],
                                         chunk_bytes=1 << 17,
                                         workers_per_hop=2)
    rates = rep.link_gbps()
    assert rates and all(g > 0 for g in rates.values())
    return rates


def _belief_sequence(cal, core, top, name, rates):
    """(belief, what each step returned) after one update sequence."""
    s, d = top.index(SRC), top.index(DST)
    out = []
    if name == "link_rates":
        toy = core.toy_topology(n=5, seed=2)
        bel = cal.BeliefGrid(toy)
        out.append(bel.observe_link_rates(rates, weight=1.0, t_s=1.0,
                                          one_sided=False))
        a, b = next(iter(rates))
        out.append(bel.observe_link_rates({(a, b): 0.01 * bel.mean[a, b]},
                                          t_s=2.0))
        out.append(bel.observe_link_rates(rates, t_s=3.0))
        return bel, out
    bel = cal.BeliefGrid(top)
    g0 = float(bel.mean[s, d])
    if name == "observe":
        for k in range(6):
            bel.observe(s, d, 0.9 * g0, weight=1.0, t_s=float(k))
    elif name == "observe_adaptive":
        out.append(bel.observe_adaptive(s, d, 0.05 * g0, weight=1.0))
        out.append(bel.observe_adaptive(s, d, 0.052 * g0, weight=1.0,
                                        t_s=4.0))
        out.append(bel.observe_adaptive(s, d, 3.0 * g0, weight=2.0,
                                        z_reset=1.0, t_s=8.0))
    elif name == "scale_grid":
        out.append(bel.scale_grid(top, z=1.5).tolist())
        bel.reset_link(s, d, 0.1 * float(top.tput[s, d]))
        out.append(bel.scale_grid(top, z=1.5).tolist())
        out.append(bel.scale_grid(top, z=0.0, floor=0.1).tolist())
    elif name == "reset_link":
        bel.reset_link(s, d, 1.0)
        bel.reset_link(d, s, 0.2 * float(top.tput[d, s]), t_s=3.0)
        out.append(bel.sigma().tolist())
    elif name == "roll_epoch":
        for b in range(top.num_regions):
            if b != s and top.tput[s, b] > 0:
                bel.reset_link(s, b, 0.05 * float(top.tput[s, b]))
        snap = bel.snapshot(t_s=1.0)
        bel.observe(s, d, g0, weight=4.0, t_s=2.0)
        bel.roll_epoch()
        out += [snap.version, snap.epoch, snap.lower_bound(1.5).tolist(),
                np.asarray(bel.believed_topology().tput).tolist()]
    else:
        raise KeyError(name)
    return bel, out


BELIEF_SEQUENCES = ("observe", "observe_adaptive", "scale_grid",
                    "reset_link", "roll_epoch", "link_rates")


@pytest.fixture(scope="module")
def gateway_rates():
    return _gateway_rates()


@pytest.mark.parametrize("name", BELIEF_SEQUENCES)
def test_belief_grid_equals_reference(name, tops, gateway_rates):
    want_bel, want = _belief_sequence(ref_cal, ref_core, tops["ref"], name,
                                      gateway_rates)
    got_bel, got = _belief_sequence(port_cal, port_core, tops["port"], name,
                                    gateway_rates)
    assert got == want
    assert _belief_state(got_bel) == _belief_state(want_bel)
    if name == "link_rates":
        assert got[0] == len(gateway_rates) and got[1] == 0


# --------------------------------------------------------------- policies
def _policy_rounds(cal, core, top, policy, budget, rounds=4):
    """Probe rounds of one policy against a frozen drifted truth (the
    reference's probe-policy tests), every round's records."""
    truth = cal.DriftModel(top, seed=11, drift_sigma=0.3,
                           diurnal_amp=0.0).tput_at(500.0)
    pl = core.Planner(top, max_relays=6)
    plan = pl.plan_cost_min(SRC, DST, 3.0, 4.0)
    bel = cal.BeliefGrid(top)
    calr = cal.Calibrator(bel, policy=cal.make_policy(policy, seed=5),
                          budget=cal.ProbeBudget(**budget))
    out = []
    for k in range(rounds):
        rnd = calr.run_round(float(k), truth, planner=pl,
                             contexts=[(SRC, DST)], plans=[plan])
        out.append(dataclasses.asdict(rnd))
    out.append(calr.total_probes)
    out.append(_belief_state(bel))
    return out


BUDGETS = {
    "tight": dict(usd_per_round=0.08, seconds_per_round=15.0,
                  max_probes_per_round=3),
    "wide": dict(usd_per_round=1.0, seconds_per_round=30.0,
                 max_probes_per_round=6),
}


@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("policy", port_cal.POLICY_NAMES)
def test_policy_rounds_equal_reference(policy, budget, tops):
    want = _policy_rounds(ref_cal, ref_core, tops["ref"], policy,
                          BUDGETS[budget])
    got = _policy_rounds(port_cal, port_core, tops["port"], policy,
                         BUDGETS[budget])
    assert got == want
    assert all(r["records"] for r in got[:4])


def _evoi_stale_rank(cal, core, top):
    """test_probe_policies' stale-plan-link ranking, by EVOI and greedy."""
    pl = core.Planner(top, max_relays=6)
    plan = pl.plan_cost_min(SRC, DST, 4.0, 8.0)
    bel = cal.BeliefGrid(top)
    links = cal.Calibrator(bel).candidate_links(pl, [(SRC, DST)])
    a, b = max(((a, b) for a, b in links if plan.F[a, b] > 1e-9),
               key=lambda e: plan.F[e])
    for x, y in links:
        t_obs = 0.0 if (x, y) == (a, b) else 59.0
        bel.observe(x, y, float(bel.mean[x, y]), weight=8.0, t_s=t_obs)
    ctx = cal.PolicyContext(belief=bel, t_s=60.0, planner=pl,
                            contexts=((SRC, DST),), plans=(plan,))
    return [list(links), (a, b)] + [
        cal.make_policy(p, seed=3).rank(list(links), ctx).tolist()
        for p in cal.POLICY_NAMES
    ]


def test_policy_ranks_equal_reference(tops):
    got = _evoi_stale_rank(port_cal, port_core, tops["port"])
    assert got == _evoi_stale_rank(ref_cal, ref_core, tops["ref"])
    links, stale, evoi = got[0], got[1], got[2 + 3]
    assert stale in [tuple(links[i]) for i in evoi[:3]]


# -------------------------------------------------------- the segment sim
def _drain_case(core, tr):
    """test_calibration's drain scenario: a slow link whose per-chunk ETA
    exceeds the horizon, cut hard and drained."""
    top = core.toy_topology(n=5, seed=2)
    plan = core.Planner(top, max_relays=3).plan_cost_min("toy:r0", "toy:r1",
                                                         1.0, 0.05)
    job = tr.TransferJob(plan=plan, name="slow", chunk_mb=16.0)
    return [job], top.with_tput(scale=0.02)


def _assert_sims_equal(got, want):
    assert got.time_s == want.time_s and got.events == want.events
    assert len(got.jobs) == len(want.jobs)
    for a, b in zip(got.jobs, want.jobs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("drain", [False, True], ids=["hard", "drain"])
def test_drain_segment_equals_reference(drain):
    want_jobs, want_top = _drain_case(ref_core, ref_transfer)
    got_jobs, got_top = _drain_case(port_core, port_transfer)
    kw = dict(seed=0, horizon_s=0.5, drain=drain)
    want = ref_simulate(want_jobs, (), exec_top=want_top, engine="soa", **kw)
    for engine in ("soa", "torch"):
        got = port_transfer.simulate(got_jobs, (), exec_top=got_top,
                                     engine=engine, device="cpu", **kw)
        _assert_sims_equal(got, want)
    delivered = want.jobs[0].chunks_delivered
    assert (delivered > 0 and want.time_s > 0.5) if drain else delivered == 0


def _recorded_segments(tops):
    """Each segment sim of the reference's step-change service (calibrated
    arm, numpy planner): its jobs and arguments, as the service passed
    them."""
    calls = []

    def spy(jobs, faults, **kw):
        res = ref_simulate(jobs, faults, engine="soa", **kw)
        calls.append((jobs, kw, res))
        return res

    api = _api("ref", "numpy", None, tops)
    svc = _step_change_service(api, calibrate=True)
    svc.run(sim=spy)
    return calls


def test_calibrated_segments_equal_reference(tops):
    """Every segment of a calibrated run on the true topology frozen at
    the segment's start, drained: the port's ``soa`` and ``torch`` engines
    equal the reference's ``soa``, the telemetry maps included."""
    calls = _recorded_segments(tops)
    assert len(calls) >= 3
    for jobs, kw, want in calls:
        assert kw["drain"] is True and kw["exec_top"] is not None
        pkw = dict(kw, exec_top=convert.to_port_topology(kw["exec_top"]))
        for engine in ("soa", "torch"):
            got = port_transfer.simulate(convert.to_port_jobs(jobs), (),
                                         engine=engine, device="cpu", **pkw)
            _assert_sims_equal(got, want)
            for j in got.jobs:
                assert j.per_edge_obs_gb is not None
                assert j.per_edge_active_s is not None


# ---------------------------------------------------------------- service
def _step_change_service(api, calibrate):
    top = api.top
    s, d = top.index(SRC), top.index(DST)
    drift = api.cal.DriftModel(
        top, seed=0, drift_sigma=0.10, diurnal_amp=0.0,
        incidents=[api.cal.Incident(src=s, dst=d, t_start_s=6.0,
                                    duration_s=1e9, severity=0.08)])
    svc = api.cal.CalibratedTransferService(
        drift, max_relays=6, calibrate=calibrate, check_interval_s=4.0,
        max_segments=120, **api.svc)
    svc.submit(api.tr.TransferRequest("big", SRC, DST, 8.0, 4.0))
    return svc


def _step_change(api):
    """test_calibration's step-change incident: the calibrated service,
    then the stale baseline."""
    runs = []
    for calibrate in (True, False):
        svc = _step_change_service(api, calibrate)
        runs.append((svc, svc.run()))
    return runs


def _quiet(api, kind):
    """test_calibration's no-drift, multicast and probe-spend services."""
    seed, sigma = {"no_drift": (5, 0.01), "multicast": (4, 0.02),
                   "probe_spend": (2, 0.05)}[kind]
    drift = api.cal.DriftModel(api.top, seed=seed, drift_sigma=sigma,
                               diurnal_amp=0.0)
    svc = api.cal.CalibratedTransferService(drift, max_relays=6,
                                            check_interval_s=4.0, **api.svc)
    if kind == "multicast":
        svc.submit(api.tr.TransferRequest("repl", MC_SRC, "", 3.0, 1.5,
                                          dsts=MC_DSTS))
    else:
        name = "calm" if kind == "no_drift" else "probe-bill"
        svc.submit(api.tr.TransferRequest(name, SRC, DST, 4.0, 3.0))
    return [(svc, svc.run())]


def _roll_service(api, factor, **kw):
    """test_probe_policies' epoch-roll service: the source's egress
    believed at ``factor`` of the truth."""
    top = api.top
    s = top.index(SRC)
    bel = api.cal.BeliefGrid(top)
    for b in range(top.num_regions):
        if b != s and top.tput[s, b] > 0:
            bel.reset_link(s, b, factor * top.tput[s, b])
    drift = api.cal.DriftModel(top, seed=0, drift_sigma=0.02,
                               diurnal_amp=0.0)
    svc = api.cal.CalibratedTransferService(
        drift, belief=bel, max_relays=6, check_interval_s=4.0,
        policy="round_robin", max_segments=120, **kw, **api.svc)
    svc.submit(api.tr.TransferRequest("roll", SRC, DST, 4.0, 4.0))
    return svc, svc.run()


def _rolls(api, factor, arms):
    return [_roll_service(api, factor, **kw) for kw in arms]


SCENARIOS = {
    "step_change": _step_change,
    "no_drift": lambda api: _quiet(api, "no_drift"),
    "multicast": lambda api: _quiet(api, "multicast"),
    "probe_spend": lambda api: _quiet(api, "probe_spend"),
    # the roll fires under a 20x-undersold belief, and is capped
    "roll": lambda api: _rolls(api, 0.05, [{"max_epoch_rolls": 2},
                                           {"max_epoch_rolls": 0}]),
    # a mildly undersold belief: no roll, then one past a lower threshold
    "roll_threshold": lambda api: _rolls(
        api, 0.95, [{"max_epoch_rolls": 2},
                    {"max_epoch_rolls": 2, "epoch_roll_threshold": 1.01}]),
}


def _achieved(rep) -> float:
    return rep.jobs[0].delivered_gb * 8.0 / max(rep.time_s, 1e-9)


def _exercised(name, runs, top) -> None:
    """What the reference's tests assert of each scenario, so that the
    equalities are not vacuous."""
    reps = [r for _, r in runs]
    assert all(j.status == "done" and j.lost_chunks == 0
               for r in reps for j in r.jobs)
    if name == "step_change":
        cal, stale = reps
        assert cal.drift_events and cal.replans and not stale.replans
        assert all(r.structure_builds == 0 for r in cal.replans)
        assert _achieved(cal) >= 1.5 * _achieved(stale)
        s, d = top.index(SRC), top.index(DST)
        assert cal.replans[-1].plan.F[s, d] <= 0.25 * 4.0
    elif name == "no_drift":
        assert not reps[0].drift_events and not reps[0].replans
    elif name in ("multicast", "probe_spend"):
        svc, rep = runs[0]
        assert rep.probe_rounds and rep.probe_cost_usd > 0
        assert all(r.cost_usd <= svc.calibrator.budget.usd_per_round + 1e-12
                   for r in rep.probe_rounds)
    elif name == "roll":
        (svc, rolled), (_, capped) = runs
        assert 1 <= len(rolled.epoch_rolls) <= 2 and svc.planner.top is svc.top
        assert 0 < rolled.epoch_roll_builds <= 8
        assert all(any(abs(r.t_s - b) < 1e-9 for b in rolled.boundaries)
                   for r in rolled.epoch_rolls)
        assert not capped.epoch_rolls
        assert _achieved(rolled) > _achieved(capped)
    else:
        calm, eager = reps
        assert not calm.epoch_rolls and eager.epoch_rolls


def compare_runs(scenario, pairing, tops):
    """Run ``scenario`` through the reference and through the port on
    ``engine="soa"`` and ``"torch"``; hold every run's
    ``service_record``. Returns the port's torch-engine runs."""
    want = [service_record(*run)
            for run in scenario(_api("ref", pairing, None, tops))]
    rtol = 0.0 if pairing == "numpy" else TORCH_JAX_RTOL
    for engine in ("soa", "torch"):
        runs = scenario(_api("port", pairing, engine, tops))
        assert_same([service_record(*run) for run in runs], want, rtol)
    return runs


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_service_equals_reference_numpy_planner(name, tops):
    runs = compare_runs(SCENARIOS[name], "numpy", tops)
    _exercised(name, runs, tops["port"])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_service_equals_reference_batched_ipm(name, tops, x64_shim):
    runs = compare_runs(SCENARIOS[name], "torch", tops)
    _exercised(name, runs, tops["port"])


# ------------------------------------------------------------ entry rules
def test_rejects_scripted_faults(tops):
    api = _api("port", "numpy", "soa", tops)
    svc = api.cal.CalibratedTransferService(api.cal.DriftModel(api.top),
                                            **api.svc)
    svc.submit(api.tr.TransferRequest("x", SRC, DST, 1.0, 2.0))
    with pytest.raises(ValueError, match="DriftModel"):
        svc.run(faults=[api.tr.LinkDegrade(t_s=1.0, src=0, dst=1,
                                           factor=0.5)])


@pytest.mark.parametrize("engine", ["soa", "torch"])
def test_segments_run_on_the_services_engine_and_device(engine, tops,
                                                        monkeypatch):
    """With no ``sim``, every segment goes to ``transfer.sim.simulate`` on
    the service's own engine and device."""
    from repro_torch.transfer import sim as sim_mod

    seen = []
    real = sim_mod.simulate

    def spy(jobs, faults, **kw):
        seen.append((kw["engine"], kw["device"], kw["exec_top"] is not None,
                     kw["drain"]))
        return real(jobs, faults, **kw)

    monkeypatch.setattr(sim_mod, "simulate", spy)
    [(_, rep)] = _quiet(_api("port", "numpy", engine, tops), "no_drift")
    assert len(seen) == rep.segments >= 1
    assert set(seen) == {(engine, "cpu", True, True)}


def test_caller_sim_gets_the_segments_arguments(tops):
    """A caller's ``sim`` receives what the reference passes it, and not
    the service's own engine or device."""
    calls = []

    def sim(jobs, faults, **kw):
        calls.append(sorted(kw))
        return port_transfer.simulate(jobs, faults, engine="soa", **kw)

    api = _api("port", "numpy", "torch", tops)
    svc = _step_change_service(api, calibrate=True)
    rep = svc.run(sim=sim)
    assert calls == [["drain", "exec_top", "horizon_s",
                      "link_capacity_scale", "seed"]] * rep.segments


def test_no_device_means_the_card(tops):
    """``CalibratedTransferService(drift)`` plans and simulates on the
    card; with no card its ``run`` raises and nothing runs on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("with a card present, device=None is the card")
    drift = port_cal.DriftModel(tops["port"], seed=0)
    svc = port_cal.CalibratedTransferService(drift, max_relays=6)
    assert (svc.backend, svc.engine, svc.device) == ("torch", "torch", None)
    svc.submit(port_transfer.TransferRequest("j", SRC, DST, 1.0, 2.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.run()
    numpy_planned = port_cal.CalibratedTransferService(
        drift, backend="numpy", max_relays=6)
    numpy_planned.submit(port_transfer.TransferRequest("j", SRC, DST, 1.0,
                                                       2.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        numpy_planned.run()  # the sim's device, this time
