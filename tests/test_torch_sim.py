"""The port's sim engine against the reference package's engines.

Every scenario of ``tests/test_sim_engines.py`` runs on the reference's
``engine="soa"`` (numpy) and ``engine="jax"`` and, carried across with
``repro_torch.convert``, on the port's ``simulate(engine="torch",
device="cpu")``. The pins are the reference's own soa-vs-jax pins: every
``JobSimResult`` field, the event count and the run's wall time are
BITWISE equal, and the Skytrace streams are tuple-identical.

The reference's jax engine imports only under the x64 shim, installed for
this module alone and removed again on teardown (with every module
imported under it), so the reference's own engine tests see the same
imports whichever worker runs them.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro.core import Planner, PlanSpec, default_topology, direct_plan
from repro.obs import trace as ref_trace
from repro.transfer import (
    GrayFailure,
    LinkDegrade,
    LinkRestore,
    TransferJob,
    VMFailure,
)
from repro.transfer import simulate as ref_simulate
from repro_torch import convert
from repro_torch.core import milp as port_milp
from repro_torch.obs import trace as port_trace
from repro_torch.obs.trace import on_track
from repro_torch.obs.metrics import REGISTRY as PORT_REGISTRY
from repro_torch.core import default_topology as port_default_topology
from repro_torch.transfer import flowsim_torch, simulate
from repro_torch.transfer.flowsim_torch import simulate_multi_torch

from test_torch_cases import SIM_SCENARIOS, fleet_jobs, sim_scenario
from test_torch_cases import one_thread  # noqa: F401

SRC, DST = "aws:us-west-2", "aws:eu-central-1"
SRC2 = "gcp:us-central1"
MC_SRC = "gcp:us-central1"
MC_DSTS = ("gcp:europe-west1", "gcp:europe-west3", "gcp:europe-west4")
_SHIMMED = ("repro.transfer.flowsim_jax", "repro.core.solver.ipm_jax")


@pytest.fixture(scope="module")
def x64_shim():
    import jax
    import jax.experimental

    had = hasattr(jax.experimental, "enable_x64")
    if not had:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    try:
        yield
    finally:
        if not had:
            del jax.experimental.enable_x64
            for name in _SHIMMED:
                sys.modules.pop(name, None)
                parent, _, child = name.rpartition(".")
                pkg = sys.modules.get(parent)
                if pkg is not None and child in vars(pkg):
                    delattr(pkg, child)


@pytest.fixture(scope="module")
def top():
    return default_topology()


@pytest.fixture(scope="module")
def port_top():
    return port_default_topology()


def _unicast_jobs(top, volume=0.5):
    return [
        TransferJob(direct_plan(top, SRC, DST, volume, num_vms=2), "a"),
        TransferJob(direct_plan(top, SRC, DST, volume, num_vms=2), "b",
                    arrival_s=1.0),
        TransferJob(direct_plan(top, SRC2, DST, volume, num_vms=2), "c"),
    ]


def _all_faults(top):
    s, d, s2 = top.index(SRC), top.index(DST), top.index(SRC2)
    return [
        LinkDegrade(t_s=0.5, src=s, dst=d, factor=0.5),
        GrayFailure(t_s=0.8, src=s2, dst=d, factor=0.4),
        VMFailure(t_s=1.0, job=0, region=s, count=1),
        LinkRestore(t_s=1.4, src=s, dst=d, factor=2.0),
        GrayFailure(t_s=1.6, src=s2, dst=d, factor=2.5),
    ]


def _mixed_jobs(top):
    mc = Planner(top, max_relays=6).plan(PlanSpec(
        objective="cost_min", src=MC_SRC, dsts=MC_DSTS,
        tput_goal_gbps=2.0, volume_gb=1.0,
    ))
    assert mc.solver_status == "optimal"
    jobs = [
        TransferJob(mc, "repl"),
        TransferJob(direct_plan(top, SRC, DST, 0.5, num_vms=2), "uni",
                    arrival_s=0.5),
    ]
    kill = next(int(r) for r in mc.dsts if mc.N[r] >= 1)
    return jobs, [VMFailure(t_s=0.8, job=0, region=kill, count=1)]


def _tied_jobs(top):
    return [
        TransferJob(direct_plan(top, SRC, DST, 0.25, num_vms=2), "x",
                    arrival_s=1.0),
        TransferJob(direct_plan(top, SRC2, DST, 0.25, num_vms=2), "y",
                    arrival_s=1.0),
        TransferJob(direct_plan(top, SRC, DST, 0.25, num_vms=2), "z"),
    ]


def _scenario(name, top):
    """(jobs, faults, sim kwargs) of each test_sim_engines scenario."""
    s, d = top.index(SRC), top.index(DST)
    if name == "plain":
        return _unicast_jobs(top), [], {}
    if name == "every_event":
        return _unicast_jobs(top), _all_faults(top), {}
    if name in ("horizon_cut", "horizon_drain"):
        faults = [LinkDegrade(t_s=0.4, src=s, dst=d, factor=0.3)]
        kw = {"horizon_s": 1.0, "drain": name == "horizon_drain"}
        return _unicast_jobs(top), faults, kw
    if name == "contention_off":
        return _unicast_jobs(top), [], {"link_capacity_scale": None}
    if name == "multicast_mix":
        jobs, faults = _mixed_jobs(top)
        return jobs, faults, {}
    if name == "tied_arrivals":
        return _tied_jobs(top), [], {}
    raise KeyError(name)


SCENARIOS = ("plain", "every_event", "horizon_cut", "horizon_drain",
             "contention_off", "multicast_mix", "tied_arrivals")


def _run_ref(jobs, faults, engine, **kw):
    tr = ref_trace.enable(capacity=1 << 16)
    try:
        return ref_simulate(jobs, faults, engine=engine, seed=0, **kw), \
            tr.events()
    finally:
        ref_trace.disable()


def _run_port(jobs, faults, **kw):
    tr = port_trace.enable(capacity=1 << 16)
    try:
        res = simulate(convert.to_port_jobs(jobs),
                       convert.to_port_faults(faults), device="cpu", seed=0,
                       **kw)
        return res, tr.events()
    finally:
        port_trace.disable()


def _assert_bitwise(got, want):
    assert got.time_s == want.time_s
    assert got.events == want.events
    assert len(got.jobs) == len(want.jobs)
    for a, b in zip(got.jobs, want.jobs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("name", SCENARIOS)
def test_torch_engine_bitwise_vs_reference_engines(name, top, x64_shim):
    jobs, faults, kw = _scenario(name, top)
    got, got_tr = _run_port(jobs, faults, **kw)
    for engine in ("soa", "jax"):
        want, want_tr = _run_ref(jobs, faults, engine, **kw)
        _assert_bitwise(got, want)
        assert on_track(got_tr) == on_track(want_tr) == want_tr
    assert len(on_track(got_tr)) > 2


def test_scenarios_exercise_their_paths(top):
    """The scenario properties test_sim_engines asserts, on the port."""
    res = {n: _run_port(*_scenario(n, top)[:2], **_scenario(n, top)[2])[0]
           for n in ("every_event", "horizon_cut", "horizon_drain",
                     "multicast_mix")}
    assert sum(j.retried_chunks for j in res["every_event"].jobs) > 0
    assert any(j.status == "running" for j in res["horizon_cut"].jobs)
    assert res["horizon_cut"].time_s <= 1.0 + 1e-9
    assert res["horizon_drain"].time_s >= res["horizon_cut"].time_s
    repl = res["multicast_mix"].jobs[0]
    assert repl.per_dst_delivered is not None and len(repl.per_dst_delivered)


@pytest.mark.parametrize("name", ["every_event", "multicast_mix"])
def test_results_do_not_depend_on_block_size(name, top):
    """The host reads the loop flags once per block of iterations; a block
    of 1 and a block of 37 give the same result."""
    jobs, faults, kw = _scenario(name, top)
    pj, pf = convert.to_port_jobs(jobs), convert.to_port_faults(faults)
    a = simulate_multi_torch(pj, pf, device="cpu", block=1, **kw)
    b = simulate_multi_torch(pj, pf, device="cpu", block=37, **kw)
    _assert_bitwise(a, b)


def test_relay_buffer_at_capacity_takes_the_sequential_cascade(top):
    """A relay buffer of one chunk keeps the sequential cascade busy; the
    port still matches the numpy engine bit for bit."""
    jobs, faults = _mixed_jobs(top)
    got, _ = _run_port(jobs, faults, relay_buffer_chunks=1)
    want, _ = _run_ref(jobs, faults, "soa", relay_buffer_chunks=1)
    _assert_bitwise(got, want)


def test_f32_rate_solver_delivers_the_same_chunks(top):
    """The f32 solver (the TPU kernel's counterpart) is not bitwise; it
    moves every chunk and lands within f32 tolerance of the f64 run."""
    jobs = convert.to_port_jobs(_unicast_jobs(top))
    a = simulate_multi_torch(jobs, device="cpu")
    b = simulate_multi_torch(jobs, device="cpu", rate_solver="f32")
    assert [j.chunks_delivered for j in b.jobs] == [
        j.chunks_delivered for j in a.jobs
    ]
    assert all(j.status == "done" for j in b.jobs)
    assert b.time_s == pytest.approx(a.time_s, rel=1e-3)


def test_sim_builds_no_lp_structure_and_launches_nothing_on_cpu(top):
    builds0 = port_milp._struct_builds.value
    before = PORT_REGISTRY.snapshot(("kernels.",))
    _run_port(_unicast_jobs(top), [])
    assert port_milp._struct_builds.value == builds0
    assert PORT_REGISTRY.snapshot(("kernels.",)) == before


def test_no_device_means_the_card(top):
    import torch

    if torch.cuda.is_available():
        pytest.skip("with a card present, device=None is the card")
    jobs = convert.to_port_jobs(_unicast_jobs(top))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate(jobs)
    with pytest.raises(ValueError):  # the reference's jax engine is not
        simulate(jobs, engine="jax", device="cpu")  # one of the port's


def test_materialized_layout_matches_reference(top):
    from repro.transfer.events import materialize_jobs as ref_mat
    from repro_torch.transfer.events import materialize_jobs as port_mat

    jobs, _ = _mixed_jobs(top)
    a, b = ref_mat(jobs, seed=3), port_mat(convert.to_port_jobs(jobs), seed=3)
    for f in dataclasses.fields(a):
        if f.name == "top":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif f.name == "chunk_path":
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", SIM_SCENARIOS)
def test_port_built_scenarios_are_the_reference_scenarios(name, top,
                                                          port_top):
    """``test_torch_cases.sim_scenario`` (the port alone, for the card
    tests) runs the same as this file's scenarios carried across from the
    reference."""
    ref_name = "multicast_mix" if name == "relay_buffer_1" else name
    jobs, faults, kw = _scenario(ref_name, top)
    if name == "relay_buffer_1":
        kw = {"relay_buffer_chunks": 1}
    want, want_tr = _run_port(jobs, faults, **kw)
    pj, pf, pkw = sim_scenario(name, port_top)
    assert pkw == kw
    tr = port_trace.enable(capacity=1 << 16)
    try:
        got = simulate(pj, pf, device="cpu", seed=0, **pkw)
        got_tr = tr.events()
    finally:
        port_trace.disable()
    _assert_bitwise(got, want)
    assert on_track(got_tr) == on_track(want_tr)


@pytest.mark.parametrize("name", SIM_SCENARIOS)
def test_state_keeps_its_storage_for_the_whole_run(name, port_top,
                                                   monkeypatch):
    """Every state tensor keeps its storage from the first segment to the
    end of the run, through scripted events, the sequential cascade and
    the host's resets: the property the card's CUDA graphs rely on."""
    jobs, faults, kw = sim_scenario(name, port_top)
    seen = []
    segment = flowsim_torch._segment

    def spy(st, *args):
        seen.append([getattr(st, f).data_ptr() for f in flowsim_torch._FIELDS])
        segment(st, *args)
        seen.append([getattr(st, f).data_ptr() for f in flowsim_torch._FIELDS])

    monkeypatch.setattr(flowsim_torch, "_segment", spy)
    seq0 = PORT_REGISTRY.counter("sim.seq_cascades").value
    simulate(jobs, faults, device="cpu", **kw)
    assert len(seen) >= 2
    assert all(ptrs == seen[0] for ptrs in seen)
    assert len(set(seen[0])) == len(seen[0])  # no two share storage
    if name == "relay_buffer_1":
        assert PORT_REGISTRY.counter("sim.seq_cascades").value > seq0


@pytest.mark.parametrize("n_jobs,solver,fit", [
    (4, "f64", True), (22, "f64", True), (23, "f64", False),
    (48, "f64", False), (23, "f32", True), (48, "f32", False)])
def test_sim_sends_solves_past_shared_memory_to_the_device_memory_variant(
        n_jobs, solver, fit, port_top):
    """The sim decides once, when it builds its state, which water-filling
    kernel its solves take, by ``ops.needs_cluster`` (the mirror of the
    library's size rule): one block where an f64 solve's operands all fit
    its shared memory staged (the staged kernel: 4 jobs, 2,048 lanes) or
    an f32 solve's lanes fit it (``ops.smem_bytes``, which ``fit``
    gives); otherwise it allocates the lane scratch of
    ``ops.scratch_bytes`` that sends them to the cluster kernel, whose
    cluster then holds the lanes in its shared memory. 22 f64 jobs
    (11,264 lanes) fit the one-block layout but not the staged one, and
    take the cluster: f64 has no other one-block kernel."""
    from repro_torch.kernels.waterfill import ops as wf
    from repro_torch.transfer.events import materialize_jobs
    from repro_torch.transfer.simconfig import resolve

    su = materialize_jobs(fleet_jobs(port_top, n_jobs))
    sc, cn, _ = flowsim_torch._build(su, resolve(None), [], solver, "cpu")
    elem = 8 if solver == "f64" else 4
    fits = wf.smem_bytes(sc.ncp, sc.nv, sc.ne, elem) <= wf.SMEM_LIMIT
    assert fits == fit
    staged = wf.takes_shared(sc.ncp, sc.nv, sc.ne, solver)
    assert staged == (n_jobs == 4 and solver == "f64")
    plan = wf.launch_plan(sc.ncp, sc.nv, sc.ne, solver)
    if staged or (fits and solver == "f32"):
        assert cn.wf_lanes is None
        assert plan.kernel == ("waterfill_f64_shared" if staged
                               else "waterfill_f32") and plan.k == 1
    else:
        assert cn.wf_lanes.dtype == torch.uint8
        assert cn.wf_lanes.numel() == wf.scratch_bytes(sc.ncp, elem)
        assert plan.kernel == f"waterfill_{solver}_cluster"
        assert plan.k in (2, 4) and plan.lanes_shared
