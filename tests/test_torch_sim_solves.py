"""The sim's count of water-filling solves against the reference's numpy
engine.

``sim.solves`` counts the iterations whose active lanes moved or whose
cached rates were invalidated: the solves the water-filling launch really
makes (the others answer from the cache). The reference's numpy engine
(``repro.transfer.flowsim``, ``engine="soa"``) solves on the same
condition, so for one sim the count equals the number of its
``_maxmin_rates_arr`` calls on the same inputs and sim seed. The cases
(``test_torch_cases.SOLVE_CASES``) are Skyplane's OPT-66B broadcast and a
direct 2-VM transfer at 200 chunks, the broadcast also with scripted
faults that invalidate the cache and with relay buffers of one chunk, so
that the host's sequential cascade runs. They are built with the
reference's planner and carried across with ``repro_torch.convert``, as
in ``tests/test_torch_sim.py``; ``tests/test_torch_cuda_kernels.py``
builds them with the port's planner and holds the card's count to the
CPU's.
"""

from __future__ import annotations

import dataclasses

import pytest

from repro import core as ref_core
from repro import transfer as ref_transfer
from repro.transfer import flowsim
from repro_torch import convert
from repro_torch import core as port_core
from repro_torch import transfer as port_transfer
from repro_torch.obs.metrics import REGISTRY
from repro_torch.transfer import simulate

from test_torch_cases import SOLVE_CASES, solve_case, solve_plans
from test_torch_cases import one_thread  # noqa: F401

_COUNTERS = ("sim.solves", "sim.iterations", "sim.seq_cascades")


@pytest.fixture(scope="module")
def ref_plans():
    return solve_plans(ref_core)


@pytest.fixture(scope="module")
def port_plans():
    return solve_plans(port_core)


def _port(jobs, faults, kw, seed):
    before = {c: REGISTRY.counter(c).value for c in _COUNTERS}
    res = simulate(jobs, faults, engine="torch", device="cpu", seed=seed,
                   **kw)
    return res, {c: REGISTRY.counter(c).value - before[c] for c in _COUNTERS}


def _assert_bitwise(got, want):
    assert got.time_s == want.time_s
    assert got.events == want.events
    assert len(got.jobs) == len(want.jobs)
    for a, b in zip(got.jobs, want.jobs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("name", SOLVE_CASES)
def test_solves_equal_the_numpy_engines_solves(name, ref_plans, monkeypatch):
    """One sim's ``sim.solves`` equals the numpy engine's solves on the
    same inputs, faults and seed, and the results are bitwise equal too;
    the broadcast solves in most of its iterations, and the relay-full
    case takes the host's sequential cascade."""
    jobs, faults, kw, seed = solve_case(name, ref_plans, ref_transfer)
    got, d = _port(convert.to_port_jobs(jobs),
                   convert.to_port_faults(faults), kw, seed)
    seen = []
    solve = flowsim._maxmin_rates_arr

    def counted(*args, **kwargs):
        seen.append(1)
        return solve(*args, **kwargs)

    monkeypatch.setattr(flowsim, "_maxmin_rates_arr", counted)
    want = ref_transfer.simulate(jobs, faults, engine="soa", seed=seed, **kw)
    _assert_bitwise(got, want)
    assert d["sim.solves"] == len(seen) > 0
    assert d["sim.solves"] <= got.events <= d["sim.iterations"]
    assert (d["sim.seq_cascades"] > 0) == (name == "bcast_relay_full")
    if name.startswith("bcast"):
        assert d["sim.solves"] > d["sim.iterations"] // 2


def test_the_broadcast_is_skyplanes(ref_plans):
    """The cases' broadcast has the benchmark's shape: 12 VMs in the source
    and its six destination regions, 36 edges and 637 connections, with a
    floor of 10 Gbit/s to each destination."""
    top, bcast, _ = ref_plans
    assert bcast.solver_status == "optimal" and bcast.validate() == []
    regions = {top.keys()[r] for r in bcast.N.nonzero()[0]}
    assert regions == {top.keys()[bcast.src],
                       *(top.keys()[d] for d in bcast.dsts)}
    assert len(regions) == 7 and bcast.N.sum() == 12
    assert (bcast.M > 0).sum() == 36 and bcast.M.sum() == 637
    assert min(bcast.tput_goals) == pytest.approx(10.0, rel=1e-6)


@pytest.mark.parametrize("name", SOLVE_CASES)
def test_port_built_cases_are_the_reference_cases(name, ref_plans,
                                                  port_plans):
    """The cases built with the port's planner (the card test's) run as
    the reference-built cases carried across."""
    jobs, faults, kw, seed = solve_case(name, ref_plans, ref_transfer)
    want, d_want = _port(convert.to_port_jobs(jobs),
                         convert.to_port_faults(faults), kw, seed)
    got, d_got = _port(*solve_case(name, port_plans, port_transfer)[:2],
                       kw, seed)
    _assert_bitwise(got, want)
    assert d_got == d_want

