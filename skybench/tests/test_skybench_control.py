"""The comparison that decides ``correct`` is shown to fail: by the
control, the program's own float32 water-filling, and by the timed path
broken underneath a whole run (the chip's look skipped, the CPU in its
place).

Faults a sim can have, each planted in the program: the loop's step
returns its state unchanged; half of each job's chunks left out where
the scenario is made; an answer altered (one job's time by one ulp)
where the result is produced. The exchange between chips does not exist
here: every cell runs on one card."""

import dataclasses

import numpy as np
import pytest

from skybench.tests.tiny import CELLS, tiny


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_where_the_program_passes(name):
    from skybench import control, judge

    rows = control.readings(tiny(name), 2**31 + 21, 3, device="cpu")
    assert len(rows) == 3
    for r in rows:
        assert judge.within(r["program"]), r
        assert not judge.within(r["control"]), r
        assert r["control"]["fields_differing"] > 0
        assert 0 < r["control"]["max_rel_gap"] < 1e-3


def _unchanged_state(mp):
    from repro_torch.transfer import flowsim_torch

    mp.setattr(flowsim_torch, "_step", lambda st, cn, sc, go: None)


def _half_the_chunks(mp):
    from repro_torch.transfer import events

    made = events.materialize_jobs

    def half(*a, **k):
        su = made(*a, **k)
        return dataclasses.replace(su, n_chunks=np.maximum(
            su.n_chunks // 2, 1))

    mp.setattr(events, "materialize_jobs", half)


def _altered_answer(mp):
    from repro_torch.transfer import flowsim_torch

    finalize = flowsim_torch._finalize

    def altered(*a, **k):
        res = finalize(*a, **k)
        j0 = res.jobs[0]
        j0 = dataclasses.replace(j0, time_s=float(np.nextafter(
            j0.time_s, np.inf)))
        return dataclasses.replace(res, jobs=[j0, *res.jobs[1:]])

    mp.setattr(flowsim_torch, "_finalize", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_chunks,
                                   _altered_answer],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_reads_not_correct(name, fault, monkeypatch):
    from skybench import harness

    fault(monkeypatch)
    line = harness.run(tiny(name), 2**31 + 33, 0.2, False, device="cpu")
    assert line["correct"] is False
    assert line["failed"] == line["attempted"] >= 1
    assert line["checks"]["fields_differing"]["value"] > 0
