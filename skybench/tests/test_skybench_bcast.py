"""The OPT-66B broadcast's frozen plan, and the reader of the program's
count of solves: its value from a given slice, and nothing, without
raising, where the program has no such counter (it reads 0)."""

import dataclasses

import pytest

from skybench import cells, devtrace, harness

BCAST = "bcast-opt66b-gcp7.weights"


@pytest.mark.parametrize("solves", [0, 19])
def test_waterfill_us_per_solve(solves):
    """The slice's water-filling device time over its ``sim.solves``; the
    other kernels are not counted."""
    wf = "void waterfill_kernel<double>(...)"
    kernels = [(wf, 0.0, 20.0), ("sim_pre_kernel", 20.0, 25.0),
               (wf, 30.0, 40.0)]
    r = harness.Readings(
        setup_s=10.0, window_s=50.0, window_sims=2, window_events=2_000,
        window_chunks=2_000,
        window_counters={"sim.solves": 100 * solves, "sim.iterations": 2_000},
        slice=devtrace.Slice(0.0, 50.0, kernels, []),
        slice_counters={"sim.solves": solves})
    got = cells.metric_reader("waterfill_us_per_solve").read(r)
    if not solves:
        assert got is None
    else:
        assert got == pytest.approx(30.0 / 19)


def test_the_committed_broadcast_plan():
    """The configuration's frozen plan loads through ``cells.load_plan``
    (``validate()`` clean) and holds what ``freeze_plan.py`` gave: 12 VMs
    in the source and six destination regions, 36 edges, 637
    connections, a floor of 10 Gbit/s to each destination, and 123 GB to
    each in 64 MB chunks."""
    from skybench.reference.core.profiles import default_topology

    cell = cells.load_cell(BCAST)
    (entry,) = cell.config["plans"]
    top = dataclasses.replace(default_topology(),
                              limit_conn=cell.config["connections_per_vm"])
    plan = cells.load_plan(top, entry)
    assert plan.validate() == []
    assert entry["made_by"]["spec"]["objective"] == "cost_min"
    assert entry["made_by"]["connections_per_vm"] == 64
    regions = {top.keys()[r] for r in plan.N.nonzero()[0]}
    assert regions == {top.keys()[plan.src], *entry["dsts"]}
    assert len(regions) == 7 and plan.N.sum() == 12
    assert (plan.M > 0).sum() == 36 and plan.M.sum() == 637
    assert min(plan.tput_goals) == pytest.approx(10.0, rel=1e-6)
    assert cell.config["jobs"] == 1
    gb = cell.traffic["chunks_per_job"] * cell.config["chunk_mb"] / 1024
    assert gb == 123.0
