"""Configurations that carry their plans as data (``plans``): frozen by
``freeze_plan.py``, loaded back bit for bit, refused when malformed, and
run through the harness to ``correct``; a configuration of ``routes``
builds the inputs it always built; the reference repeats itself for one
sim seed, so the harness runs it once a seed."""

import contextlib
import dataclasses
import hashlib
import io
import json

import numpy as np
import pytest

from skybench.tests.tiny import CELLS, cut, tiny

CONNECTIONS = 64
# Two small plans of the program's planner on its default topology: an
# overlay unicast that relays through one region, and a broadcast to two
# destinations that relay to each other.
SPECS = {
    "overlay": dict(objective="cost_min", src="aws:us-east-1",
                    dst="gcp:asia-southeast1", tput_goal_gbps=10.0,
                    volume_gb=8.0),
    "broadcast": dict(objective="cost_min", src="gcp:us-east1",
                      dsts=("gcp:europe-west4", "gcp:europe-west6"),
                      tput_goal_gbps=8.0, volume_gb=8.0),
}
MADE_BY = {"spec": "in the test", "commit": "none"}


@pytest.fixture(scope="module")
def planned():
    """Each spec's plan, as the planner returns it."""
    from repro_torch.core import Planner, PlanSpec, default_topology

    top = dataclasses.replace(default_topology(), limit_conn=CONNECTIONS)
    planner = Planner(top)
    return {k: planner.plan(PlanSpec(**s)) for k, s in SPECS.items()}


def _entry(plan) -> dict:
    """The plan frozen and read back as a configuration file holds it."""
    from skybench import freeze_plan

    return json.loads(json.dumps(freeze_plan.plan_entry(plan, MADE_BY)))


def _config(*entries) -> dict:
    """``direct-2vm`` with frozen plans in place of its route."""
    from skybench import cells

    base = cells.load_cell(CELLS[0]).config
    config = {k: v for k, v in base.items()
              if k not in ("routes", "vms_per_region")}
    return {**config, "name": "plans-tiny", "connections_per_vm": CONNECTIONS,
            "jobs": len(entries), "plans": list(entries)}


def _cell(config):
    from skybench import cells

    return cut(dataclasses.replace(cells.load_cell(CELLS[0]),
                                   name="plans-tiny", config=config))


def test_the_plans_relay(planned):
    """What the two plans are here to exercise: a relay region on the
    unicast path, a destination forwarding to the other in the
    broadcast."""
    u = planned["overlay"]
    assert any(r not in (u.src, u.dst) for r in np.flatnonzero(u.N))
    b = planned["broadcast"]
    assert len(b.dsts) == 2
    assert any(b.G[d, e] > 0 for d in b.dsts for e in b.dsts if d != e)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("kind", SPECS)
def test_a_frozen_plan_loads_back_bit_for_bit(planned, kind):
    from skybench import cells
    from skybench.reference.core.profiles import default_topology

    plan = planned[kind]
    top = dataclasses.replace(default_topology(), limit_conn=CONNECTIONS)
    assert top.keys() == plan.top.keys()
    got = cells.load_plan(top, _entry(plan))
    names = ["N", "M", "F"] + (["G", "tput_goals"] if kind == "broadcast"
                               else [])
    for name in names:
        assert _same_bits(getattr(got, name), getattr(plan, name)), name
    assert got.src == plan.src and got.solver_status == plan.solver_status
    if kind == "broadcast":
        assert got.dsts == list(plan.dsts)
    else:
        assert got.dst == plan.dst
        assert float(got.tput_goal).hex() == float(plan.tput_goal).hex()


def test_the_command_line_prints_the_entry(planned):
    from skybench import freeze_plan

    s = SPECS["broadcast"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert freeze_plan.main([
            "--objective", s["objective"], "--src", s["src"],
            "--dsts", ",".join(s["dsts"]),
            "--tput-goal-gbps", str(s["tput_goal_gbps"]),
            "--volume-gb", str(s["volume_gb"]), "--commit", "abc"]) == 0
    entry = json.loads(out.getvalue())
    made_by = entry.pop("made_by")
    assert made_by["commit"] == "abc"
    assert made_by["connections_per_vm"] == CONNECTIONS
    assert made_by["spec"]["dsts"] == list(s["dsts"])
    want = _entry(planned["broadcast"])
    want.pop("made_by")
    assert entry == want


@pytest.mark.parametrize("kind", SPECS)
def test_a_configuration_of_plans_runs_correct(planned, kind):
    from skybench import cells, harness

    cell = _cell(_config(_entry(planned[kind])))
    inputs = cells.build_inputs(cell)
    ref, prog = inputs.ref_jobs[0].plan, inputs.jobs[0].plan
    assert type(ref).__name__ == type(prog).__name__ == (
        "MulticastPlan" if kind == "broadcast" else "TransferPlan")
    assert ref.volume_gb == prog.volume_gb == 200 * 64.0 / 1024
    for name in ("N", "M", "F") + (("G",) if kind == "broadcast" else ()):
        assert _same_bits(getattr(ref, name), getattr(prog, name))
        assert getattr(ref, name) is not getattr(prog, name)
    for trace in (False, True):
        line = harness.run(cell, 2**31 + 77, 0.2, trace, device="cpu")
        assert line["correct"] is True and line["failed"] == 0, line
        assert line["attempted"] >= 1 + trace
        assert line["metrics"], line


def test_both_kinds_of_plan_in_one_sim(planned):
    from skybench import cells, harness

    cell = _cell(_config(_entry(planned["overlay"]),
                         _entry(planned["broadcast"])))
    assert [type(j.plan).__name__ for j in
            cells.build_inputs(cell).jobs] == ["TransferPlan",
                                               "MulticastPlan"]
    line = harness.run(cell, 2**31 + 78, 0.2, False, device="cpu")
    assert line["correct"] is True, line


def test_a_multicast_job_counts_its_chunks_at_each_destination(planned):
    from skybench import cells, harness

    inputs = cells.build_inputs(_cell(_config(
        _entry(planned["broadcast"]))))
    res = harness._reference_sim(inputs, 5)
    (job,) = res.jobs
    assert job.status == "done" and len(job.per_dst_delivered) == 2
    assert harness.delivered(job) == 2 * job.n_chunks == 2 * 200
    assert job.chunks_delivered == job.n_chunks
    unicast = harness._reference_sim(
        cells.build_inputs(tiny(CELLS[0])), 5).jobs[0]
    assert unicast.per_dst_delivered is None
    assert harness.delivered(unicast) == unicast.chunks_delivered


# how each entry is broken, on which plan, and what the refusal says
MALFORMED = {
    "unknown_region": ("overlay", "is not a region", lambda e: e["F"][0]
                       .__setitem__(0, "aws:nowhere-1")),
    "over_the_vm_limit": ("overlay", "service limit of 8", lambda e: e["N"]
                          .__setitem__(e["src"], 9.0)),
    "flow_over_capacity": ("overlay", "4b: flow exceeds", lambda e: [
        t.__setitem__(2, t[2] * 4) for t in e["F"]]),
    "flow_not_conserved": ("overlay", "4e: flow not conserved",
                           lambda e: e["F"].pop()),
    "goal_not_met": ("overlay", "4c: source egress below goal", lambda e: e
                     .__setitem__("tput_goal", e["tput_goal"] * 2)),
    "edge_given_twice": ("overlay", "is given twice", lambda e: e["M"]
                         .append(list(e["M"][0]))),
    "unknown_kind": ("overlay", "'kind' is 'anycast'", lambda e: e
                     .__setitem__("kind", "anycast")),
    "no_made_by": ("overlay", "a unicast plan has the keys",
                   lambda e: e.pop("made_by")),
    "extra_key": ("overlay", "a unicast plan has the keys",
                  lambda e: e.__setitem__("G", [])),
    "not_a_number": ("overlay", "is not a finite number", lambda e: e["F"][0]
                     .__setitem__(2, "3.5")),
    "destination_is_the_source": ("overlay", "'dst' is a region other",
                                  lambda e: e.__setitem__("dst", e["src"])),
    "destination_without_flows": ("broadcast", "one entry for each "
                                  "destination", lambda e: e["F"].popitem()),
    "source_among_destinations": ("broadcast", "distinct regions other",
                                  lambda e: e["dsts"].__setitem__(
                                      0, e["src"])),
    "commodity_over_envelope": ("broadcast", "exceeds the envelope",
                                lambda e: e.__setitem__("G", e["G"][:-1])),
}


@pytest.mark.parametrize("how", MALFORMED)
def test_a_malformed_plan_is_refused_before_any_sim(planned, how,
                                                    monkeypatch):
    from repro_torch import transfer
    from skybench import harness

    kind, says, mutate = MALFORMED[how]
    entry = _entry(planned[kind])
    mutate(entry)

    def no_sim(*a, **k):
        raise AssertionError("a sim ran")

    monkeypatch.setattr(transfer, "simulate", no_sim)
    with pytest.raises(ValueError, match=f"'plans-tiny' plans\\[0\\]: "
                       f".*{says}"):
        harness.run(_cell(_config(entry)), 1, 0.1, False, device="cpu")


@pytest.mark.parametrize("keys", [("routes", "plans"), ()],
                         ids=["both", "neither"])
def test_a_configuration_gives_routes_or_plans(planned, keys):
    from skybench import cells

    both = {**_config(_entry(planned["overlay"])),
            "routes": [["aws:us-west-2", "aws:eu-central-1"]],
            "vms_per_region": 2}
    config = {k: v for k, v in both.items()
              if k not in ("routes", "plans") or k in keys}
    with pytest.raises(ValueError, match="'routes' or 'plans'"):
        cells.build_inputs(_cell(config))


def _arrays(h, *arrs):
    for a in arrs:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())


def _digest(jobs) -> str:
    """Every input of a sim: the topology, and each job's name, arrival,
    chunk size and plan (its kind, ends, goal, volume, status and
    arrays)."""
    h = hashlib.sha256()
    top = jobs[0].plan.top
    h.update(repr([r.key for r in top.regions]).encode())
    h.update(repr((top.limit_conn, top.limit_vm)).encode())
    _arrays(h, top.tput, top.price_egress, top.price_vm, top.limit_ingress,
            top.limit_egress, top.rtt_ms)
    for j in jobs:
        p = j.plan
        assert p.top is top
        h.update(repr((type(p).__name__, j.name, j.arrival_s, j.chunk_mb,
                       p.src, p.dst, p.tput_goal, p.volume_gb,
                       p.solver_status)).encode())
        _arrays(h, p.F, p.N, p.M)
    return h.hexdigest()


def test_the_route_cells_inputs_are_the_ones_they_always_were():
    """``direct-2vm.bulk``'s inputs on both sides, whole, against their
    digest under the code before configurations could carry plans."""
    from skybench import cells

    inputs = cells.build_inputs(cells.load_cell("direct-2vm.bulk"))
    want = "451f3e98b53711245da035c0562eb5dd8fb1bd892c603c49bfe1ddb98da37e2b"
    assert _digest(inputs.ref_jobs) == want
    assert _digest(inputs.jobs) == want


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_repeats_itself_for_one_seed(name):
    from skybench import cells, harness, judge

    cell = tiny(name)
    inputs = cells.build_inputs(cell)
    s = cell.traffic["sim_seed_pool"][0]
    assert judge.compare(harness._reference_sim(inputs, s),
                         harness._reference_sim(inputs, s)) == {
        "fields_differing": 0, "max_rel_gap": 0.0}


def test_the_reference_repeats_itself_for_a_broadcast(planned):
    from skybench import cells, harness, judge

    inputs = cells.build_inputs(_cell(_config(
        _entry(planned["broadcast"]))))
    assert judge.compare(harness._reference_sim(inputs, 11),
                         harness._reference_sim(inputs, 11)) == {
        "fields_differing": 0, "max_rel_gap": 0.0}
