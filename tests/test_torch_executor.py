"""The port's ``TransferService`` against the reference package's.

Each scenario of the reference's service tests (``test_chaos.py``'s
ladders, budgets, deadlines, gray failures and breaker; the service cases
of ``test_multicast.py``; ``benchmarks/multijob_bench.py``'s service block
and ``benchmarks/chaos_bench.py``'s suite at its FAST size, seeds 0-1,
both arms) runs through both packages from the same requests and faults.
The port runs it on ``engine="soa"`` and on ``engine="torch"`` (both on
``device="cpu"``). Two planning pairings:

  * ``numpy``: ``backend="numpy"`` on both sides. The same numpy code
    plans and the same sims move the chunks, so every field is held
    EQUAL.
  * ``torch``: the port's ``backend="torch"`` (its torch IPM on the CPU)
    against the reference's ``backend="jax"`` with
    ``REPRO_BATCH_ENGINE=jax`` (its jax IPM, under the x64 shim). The two
    IPMs factor their f64 systems with different LU codes, so an
    admission plan's flows may differ in the last bits (planned
    throughput 2.0 against 1.9999999999999998); every integer, string and
    flag is held equal and every float within ``TORCH_JAX_RTOL``.

What is held is ``chip_smoke.service_record``, the record the chip script
holds the card against the CPU with: ``ServiceReport.to_dict()`` without
its ``metrics`` section (the registries are process-wide and earlier
tests leave counts in them), every job's report included; each
``ReplanRecord`` but its wall-clock ``latency_s`` (its plan's N, M, F and
status too); the breaker's transitions; each job's final plan; and the
service's degraded and gray views.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import sys
import types
from pathlib import Path

import pytest

import repro.core as ref_core
import repro.transfer as ref_transfer
import repro_torch.core as port_core
import repro_torch.transfer as port_transfer

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import service_record  # noqa: E402
from test_torch_cases import one_thread  # noqa: E402,F401

SRC, DST = "aws:us-west-2", "aws:eu-central-1"
SRC2 = "gcp:us-central1"
MC_SRC = "gcp:us-central1"
MC_DSTS = ["gcp:europe-west1", "gcp:europe-west3", "gcp:europe-west4"]
TORCH_JAX_RTOL = 1e-9
_SHIMMED = ("repro.core.solver.ipm_jax", "repro.transfer.flowsim_jax")


@pytest.fixture(scope="module")
def x64_shim():
    """The reference's jax IPM under the x64 shim, with
    ``REPRO_BATCH_ENGINE=jax``; both removed on teardown."""
    import jax
    import jax.experimental

    had = hasattr(jax.experimental, "enable_x64")
    if not had:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_BATCH_ENGINE", "jax")
    try:
        yield
    finally:
        mp.undo()
        if not had:
            del jax.experimental.enable_x64
            for name in _SHIMMED:
                sys.modules.pop(name, None)
                parent, _, child = name.rpartition(".")
                pkg = sys.modules.get(parent)
                if pkg is not None and child in vars(pkg):
                    delattr(pkg, child)


@pytest.fixture(scope="module")
def tops():
    return {"ref": ref_core.default_topology(),
            "port": port_core.default_topology()}


def _api(side, pairing, engine, tops):
    """One package's names, and the service keywords of this pairing."""
    if side == "ref":
        backend = "numpy" if pairing == "numpy" else "jax"
        return types.SimpleNamespace(
            core=ref_core, tr=ref_transfer, top=tops["ref"],
            svc={"backend": backend},
        )
    backend = "numpy" if pairing == "numpy" else "torch"
    return types.SimpleNamespace(
        core=port_core, tr=port_transfer, top=tops["port"],
        svc={"backend": backend, "device": "cpu", "engine": engine},
    )


def _service(api, **kw):
    kw.setdefault("max_relays", 6)
    return api.tr.TransferService(api.top, **api.svc, **kw)


def _index(api, *keys):
    return [api.top.index(k) for k in keys]


# ------------------------------------------------------------- scenarios
def _backoff_ladder(api):
    tr = api.tr
    svc = _service(api, backoff_ladder=tr.BackoffLadder(
        name="steep", factors=(1.0, 0.1)))
    svc.submit(tr.TransferRequest("j", SRC, DST, 2.0, 2.0))
    s, d = _index(api, SRC, DST)
    orig = svc._plan_for

    def spy(req, goal, volume_gb, **kw):
        plan = orig(req, goal, volume_gb, **kw)
        if kw.get("constrained"):
            plan.solver_status = "infeasible"  # force the full walk
        return plan

    svc._plan_for = spy
    return svc, svc.run(faults=[tr.LinkDegrade(t_s=1.0, src=s, dst=d,
                                               factor=0.5)])


def _one_fault(api, kind):
    tr = api.tr
    s, d, s2 = _index(api, SRC, DST, SRC2)
    if kind == "default_ladder":
        svc = _service(api)
        svc.submit(tr.TransferRequest("j", SRC, DST, 2.0, 2.0))
        faults = [tr.LinkDegrade(t_s=2.0, src=s, dst=d, factor=0.5)]
    elif kind in ("budget_zero", "budget_unlimited"):
        svc = _service(api)
        budget = 0 if kind == "budget_zero" else None
        svc.submit(tr.TransferRequest("rb", SRC, DST, 4.0, 2.0,
                                      retry_budget=budget))
        faults = [tr.VMFailure(t_s=1.0, job=0, region=s, count=2),
                  tr.LinkDegrade(t_s=2.0, src=s, dst=d, factor=0.9)]
    elif kind in ("no_deadline_plain", "no_deadline_ladder"):
        ladder = (tr.DegradationLadder() if kind == "no_deadline_ladder"
                  else None)
        svc = _service(api, degradation=ladder)
        svc.submit(tr.TransferRequest("n", SRC, DST, 4.0, 2.0))
        faults = [tr.LinkDegrade(t_s=1.0, src=s, dst=d, factor=0.4),
                  tr.LinkDegrade(t_s=2.0, src=s, dst=d, factor=0.9)]
    elif kind == "deadline_partial":
        svc = _service(api, degradation=tr.DegradationLadder())
        svc.submit(tr.TransferRequest("dl", SRC, DST, 8.0, 2.0,
                                      deadline_s=2.5))
        faults = [tr.LinkDegrade(t_s=t, src=s, dst=d, factor=f)
                  for t, f in ((1.0, 0.3), (2.0, 0.9), (3.0, 0.9))]
    elif kind == "deadline_generous":
        svc = _service(api, degradation=tr.DegradationLadder())
        svc.submit(tr.TransferRequest("ok", SRC, DST, 2.0, 2.0,
                                      deadline_s=500.0))
        faults = [tr.LinkDegrade(t_s=2.0, src=s, dst=d, factor=0.5)]
    elif kind == "gray_silent":
        svc = _service(api)
        svc.submit(tr.TransferRequest("g", SRC, DST, 2.0, 2.0))
        faults = [tr.GrayFailure(t_s=1.0, src=s, dst=d, factor=0.3)]
    elif kind == "gray_then_visible":
        svc = _service(api)
        svc.submit(tr.TransferRequest("g2", SRC, DST, 2.0, 2.0))
        faults = [tr.GrayFailure(t_s=0.5, src=s, dst=d, factor=0.3),
                  tr.LinkDegrade(t_s=1.5, src=s2, dst=d, factor=0.5)]
    elif kind == "breaker_half_open":
        br = tr.LinkBreaker(tr.BreakerConfig(k=2, window_s=30.0,
                                             cooldown_s=2.0))
        svc = _service(api, breaker=br)
        svc.submit(tr.TransferRequest("h", SRC, DST, 6.0, 2.0))
        faults = [
            tr.LinkDegrade(t_s=1.0, src=s, dst=d, factor=0.05),
            tr.LinkDegrade(t_s=1.5, src=s, dst=d, factor=0.9),
            tr.LinkRestore(t_s=2.0, src=s, dst=d, factor=1.0 / 0.045),
            tr.LinkDegrade(t_s=5.0, src=s2, dst=d, factor=0.99),
        ]
    else:
        raise KeyError(kind)
    return svc, svc.run(faults=faults)


def _flap_faults(tr, s, d, n=4, t0=1.0, period=1.0):
    out = []
    for i in range(n):
        t = t0 + i * period
        out.append(tr.LinkDegrade(t_s=t, src=s, dst=d, factor=0.05))
        out.append(tr.LinkRestore(t_s=t + 0.5, src=s, dst=d, factor=20.0))
    return out


def _quarantine(api, oracle_sim):
    """test_chaos's flapping trunk under the breaker; with ``oracle_sim``
    the caller hands the service the ``ref`` engine, as the chaos
    benchmark does."""
    tr = api.tr
    s, d = _index(api, SRC, DST)
    br = tr.LinkBreaker(tr.BreakerConfig(k=3, window_s=30.0, cooldown_s=60.0))
    svc = _service(api, breaker=br)
    svc.submit(tr.TransferRequest("f", SRC, DST, 4.0, 2.0))
    kw = ({"sim": functools.partial(tr.simulate, engine="ref")}
          if oracle_sim else {})
    return svc, svc.run(faults=_flap_faults(tr, s, d), **kw)


def _multicast_replan(api):
    tr = api.tr
    svc = _service(api)
    svc.submit(tr.TransferRequest("repl", MC_SRC, "", 3.0, 2.0,
                                  dsts=MC_DSTS))
    s, d0 = _index(api, MC_SRC, MC_DSTS[0])
    return svc, svc.run(faults=[tr.LinkDegrade(t_s=3.0, src=s, dst=d0,
                                               factor=0.2)])


def _flaky_backoff(api):
    tr = api.tr
    svc = _service(api)
    svc.submit(tr.TransferRequest("a", SRC, DST, 2.0, 4.0))
    orig = svc.planner.plan

    def flaky(spec):
        plan = orig(spec)
        if spec.degraded_links and (spec.tput_goal_gbps or 0.0) > 1.5:
            return dataclasses.replace(plan, solver_status="max_iter")
        return plan

    svc.planner.plan = flaky
    s, d = _index(api, SRC, DST)
    return svc, svc.run(faults=[tr.LinkDegrade(t_s=2.0, src=s, dst=d,
                                               factor=0.3)])


def _multijob_service(api):
    """benchmarks/multijob_bench.py's service block at its FAST volume."""
    tr = api.tr
    src, dst, src2 = "aws:us-east-1", "aws:ap-southeast-2", SRC2
    svc = _service(api)
    svc.submit(tr.TransferRequest("a", src, dst, 4.0, 4.0))
    svc.submit(tr.TransferRequest("b", src, dst, 4.0, 4.0, arrival_s=1.0))
    svc.submit(tr.TransferRequest("c", src2, dst, 4.0, 4.0))
    s, d = _index(api, src, dst)
    faults = [tr.LinkDegrade(t_s=2.0, src=s, dst=d, factor=0.5),
              tr.VMFailure(t_s=4.0, job=0, region=s, count=1)]
    return svc, svc.run(faults=faults, link_capacity_scale=0.8)


def _chaos_bench(api, seed, with_breaker):
    """benchmarks/chaos_bench.py's ``_run_suite`` for one seed and arm at
    its FAST size (2 GB a job)."""
    tr = api.tr
    s, d, s2 = _index(api, SRC, DST, SRC2)
    sc = tr.ChaosScenario(api.top, seed=seed, horizon_s=6.0,
                          n_brownouts=1, n_gray=1, n_flapping=1,
                          flap_count=(8, 12), flap_period_s=(2.0, 3.0),
                          links=[(s, d), (s2, d)])
    br = (tr.LinkBreaker(tr.BreakerConfig(k=3, window_s=20.0, cooldown_s=8.0))
          if with_breaker else None)
    svc = _service(api, breaker=br,
                   degradation=tr.DegradationLadder(pressure=0.25))
    budget = 10_000 if with_breaker else None
    svc.submit(tr.TransferRequest("a", SRC, DST, 2.0, 2.0, deadline_s=40.0,
                                  retry_budget=budget))
    svc.submit(tr.TransferRequest("b", SRC2, DST, 2.0, 2.0, arrival_s=1.0,
                                  deadline_s=40.0, retry_budget=budget))
    return svc, svc.run(faults=sc.events(2))


SCENARIOS = {
    "backoff_ladder": _backoff_ladder,
    **{k: functools.partial(_one_fault, kind=k) for k in (
        "default_ladder", "budget_zero", "budget_unlimited",
        "no_deadline_plain", "no_deadline_ladder", "deadline_partial",
        "deadline_generous", "gray_silent", "gray_then_visible",
        "breaker_half_open")},
    "quarantine": functools.partial(_quarantine, oracle_sim=False),
    "quarantine_oracle_sim": functools.partial(_quarantine, oracle_sim=True),
    "multicast_replan": _multicast_replan,
    "flaky_backoff": _flaky_backoff,
    "multijob_service": _multijob_service,
    **{f"chaos_bench:{seed}:{arm}": functools.partial(
        _chaos_bench, seed=seed, with_breaker=arm == "breaker")
       for seed in (0, 1) for arm in ("breaker", "baseline")},
}


# ------------------------------------------------------------ comparison
def assert_same(got, want, rtol=0.0, path="report"):
    """Equal where ``rtol`` is 0; else equal but for floats, which agree
    within ``rtol`` (relative, and absolute near zero)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, rtol, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool) and rtol:
        assert math.isclose(got, want, rel_tol=rtol, abs_tol=rtol), \
            f"{path}: {got!r} != {want!r}"
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


# (scenario, pairing, engine) -> the port's (service, report): each run
# once per module, shared by the comparisons and the path checks below
_PORT_RUNS: dict = {}


def _port_run(name, pairing, engine, tops):
    key = (name, pairing, engine)
    if key not in _PORT_RUNS:
        _PORT_RUNS[key] = SCENARIOS[name](_api("port", pairing, engine, tops))
    return _PORT_RUNS[key]


def _compare(name, pairing, tops):
    scenario = SCENARIOS[name]
    want = service_record(*scenario(_api("ref", pairing, None, tops)))
    rtol = 0.0 if pairing == "numpy" else TORCH_JAX_RTOL
    for engine in ("soa", "torch"):
        got = service_record(*_port_run(name, pairing, engine, tops))
        assert_same(got, want, rtol)
    return want


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_service_equals_reference_numpy_planner(name, tops):
    _compare(name, "numpy", tops)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_service_equals_reference_batched_ipm(name, tops, x64_shim):
    rec = _compare(name, "torch", tops)
    assert rec["jobs"] >= 1 and rec["segments"] >= 1


def test_scenarios_exercise_their_paths(tops):
    """What the reference's tests assert of these scenarios holds on the
    port's torch engine, so the equalities above are not vacuous."""
    def run(name):
        return _port_run(name, "numpy", "torch", tops)

    _, rep = run("backoff_ladder")
    rec = rep.jobs[0].replans[0]
    assert rec.ladder == "steep" and rec.backoffs == 1
    _, rep = run("budget_zero")
    assert rep.jobs[0].status == "partial" and rep.jobs[0].budget_exhausted
    _, rep = run("deadline_partial")
    assert rep.jobs[0].deadline_met is False
    assert "deadline" in {r.reason for r in rep.jobs[0].replans}
    svc, rep = run("gray_silent")
    assert rep.segments == 1 and rep.replans == [] and svc.degraded_links == {}
    svc, rep = run("breaker_half_open")
    assert [t.state for t in rep.quarantines] == ["open", "half_open",
                                                  "closed"]
    svc, rep = run("quarantine")
    assert svc.breaker.is_quarantined(tuple(_index(_api(
        "port", "numpy", "torch", tops), SRC, DST)))
    assert rep.jobs[0].status == "done"
    assert all(r.structure_builds == 0 for r in rep.replans)
    _, rep = run("multicast_replan")
    assert rep.jobs[0].status == "done" and rep.jobs[0].replans
    _, rep = run("flaky_backoff")
    assert rep.jobs[0].replans[-1].backoffs > 0
    _, rep = run("chaos_bench:0:breaker")
    assert all(j.lost_chunks == 0 for j in rep.jobs)


def test_caller_sim_gets_the_reference_arguments(tops):
    """A caller's ``sim`` receives what the reference passes it, and not
    the service's own engine or device."""
    api = _api("port", "numpy", "torch", tops)
    calls = []

    def sim(jobs, faults, **kw):
        calls.append(kw)
        return port_transfer.simulate(jobs, faults, engine="soa", **kw)

    svc = _service(api)
    svc.submit(port_transfer.TransferRequest("j", SRC, DST, 2.0, 2.0))
    s, d = _index(api, SRC, DST)
    svc.run(faults=[port_transfer.LinkDegrade(t_s=2.0, src=s, dst=d,
                                              factor=0.5)], sim=sim, drain=True)
    assert [sorted(kw) for kw in calls] == [
        ["drain", "horizon_s", "link_capacity_scale", "seed"]] * 2


def test_no_device_means_the_card(tops):
    """``TransferService(top)`` plans and simulates on the card; with no
    card its ``run`` raises and nothing runs on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("with a card present, device=None is the card")
    svc = port_transfer.TransferService(tops["port"])
    assert (svc.backend, svc.engine, svc.device) == ("torch", "torch", None)
    svc.submit(port_transfer.TransferRequest("j", SRC, DST, 2.0, 2.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.run()
    numpy_planned = port_transfer.TransferService(tops["port"],
                                                  backend="numpy")
    numpy_planned.submit(port_transfer.TransferRequest("j", SRC, DST, 2.0,
                                                       2.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        numpy_planned.run()  # the sim's device, this time
