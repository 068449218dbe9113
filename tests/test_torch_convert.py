"""Carrying planning state across: the reference package's topologies and
plans become the port's, field for field, through plain numpy state."""

from __future__ import annotations

import numpy as np
import pytest

from repro.core import Planner, PlanSpec, default_topology, direct_plan
from repro.core import grid_fingerprint as ref_fingerprint
from repro.core import toy_topology
from repro.transfer import GrayFailure, TransferJob, VMFailure
from repro_torch import convert
from repro_torch.core import MulticastPlan, Topology, TransferPlan
from repro_torch.core import grid_fingerprint
from repro_torch.transfer import events as port_events
from test_torch_cases import one_thread  # noqa: F401

_GRIDS = ("tput", "price_egress", "price_vm", "limit_ingress", "limit_egress",
          "rtt_ms")


def _assert_same_topology(a, b):
    assert [r.key for r in a.regions] == [r.key for r in b.regions]
    for ra, rb in zip(a.regions, b.regions):
        assert (ra.continent, ra.lat, ra.lon) == (rb.continent, rb.lat, rb.lon)
    for k in _GRIDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert (a.limit_conn, a.limit_vm) == (b.limit_conn, b.limit_vm)


@pytest.mark.parametrize("which", ["default", "toy"])
def test_topology_round_trip(which):
    ref = default_topology() if which == "default" else toy_topology(seed=3)
    port = convert.to_port_topology(ref)
    assert isinstance(port, Topology)
    _assert_same_topology(port, ref)
    assert grid_fingerprint(port) == ref_fingerprint(ref)
    back = convert.topology_from_state(convert.topology_state(port))
    _assert_same_topology(back, port)


def test_transfer_plan_round_trip():
    top = default_topology()
    ref = direct_plan(top, "aws:us-west-2", "aws:eu-central-1", 3.0,
                      num_vms=2)
    port = convert.to_port_plan(ref)
    assert isinstance(port, TransferPlan)
    for k in ("src", "dst", "tput_goal", "volume_gb", "solver_status"):
        assert getattr(port, k) == getattr(ref, k), k
    for k in ("F", "N", "M"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
    assert port.cost_per_gb == ref.cost_per_gb
    assert port.paths() == ref.paths()
    again = convert.plan_from_state(convert.plan_state(port), port.top)
    np.testing.assert_array_equal(again.M, port.M)


def test_multicast_plan_round_trip():
    top = default_topology()
    ref = Planner(top, max_relays=6).plan(PlanSpec(
        objective="cost_min", src="gcp:us-central1",
        dsts=("gcp:europe-west1", "gcp:europe-west3"), tput_goal_gbps=2.0,
        volume_gb=1.0,
    ))
    port = convert.to_port_plan(ref)
    assert isinstance(port, MulticastPlan)
    assert port.src == ref.src and port.dsts == ref.dsts
    for k in ("tput_goals", "G", "F", "N", "M"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
    assert port.cost_per_gb == ref.cost_per_gb
    assert [(t.rate, t.paths) for t in port.trees()] == [
        (t.rate, t.paths) for t in ref.trees()
    ]


def test_jobs_share_one_topology_and_faults_cross():
    top = default_topology()
    jobs = [
        TransferJob(direct_plan(top, "aws:us-west-2", "aws:eu-central-1",
                                1.0, num_vms=2), "a", arrival_s=0.5,
                    chunk_mb=32.0),
        TransferJob(direct_plan(top, "gcp:us-central1", "aws:eu-central-1",
                                1.0, num_vms=2), "b"),
    ]
    port = convert.to_port_jobs(jobs)
    assert port[0].plan.top is port[1].plan.top
    assert [(j.name, j.arrival_s, j.chunk_mb) for j in port] == [
        ("a", 0.5, 32.0), ("b", 0.0, 16.0)
    ]
    faults = [GrayFailure(t_s=0.8, src=1, dst=2, factor=0.4),
              VMFailure(t_s=1.0, job=0, region=3, count=2)]
    got = convert.to_port_faults(faults)
    assert got == [port_events.GrayFailure(0.8, 1, 2, 0.4),
                   port_events.VMFailure(1.0, 0, 3, 2)]
