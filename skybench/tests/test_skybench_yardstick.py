"""The yardstick's own arithmetic: the round count follows the
reference's water-filling loop, the roofline's terms, and the profiled
slice's reduction (union of device records, idle gaps by host
operation)."""

import numpy as np
import pytest

from skybench import devtrace, roofline


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("edges", [False, True])
def test_round_count_follows_the_reference_loop(seed, edges):
    from skybench.reference.transfer import flowsim

    rng = np.random.default_rng(seed)
    n, nv, ne = 200, 12, 3
    caps = rng.uniform(0.01, 2.0, n)
    src, dst = rng.integers(0, nv // 2, n), rng.integers(nv // 2, nv, n)
    eg, ing = rng.uniform(1, 20, nv), rng.uniform(1, 20, nv)
    eid = rng.integers(0, ne, n) if edges else None
    ed = rng.uniform(5, 40, ne) if edges else None
    rates, k = roofline.rounds(caps, src, dst, eg, ing, eid, ed)
    ref = flowsim._maxmin_rates_arr(caps, src, dst, eg, ing, eid=eid,
                                    edge_cap=ed)
    assert np.array_equal(rates, ref) and k >= 1


def test_counting_solves_records_and_restores():
    from skybench.reference.transfer import flowsim

    solve = flowsim._maxmin_rates_arr
    caps = np.array([1.0, 2.0, 3.0])
    idx = np.array([0, 0, 1])
    with roofline.counting_solves(flowsim) as seen:
        flowsim._maxmin_rates_arr(caps, idx, idx, np.ones(2), np.ones(2))
    assert flowsim._maxmin_rates_arr is solve
    assert seen == [(3, 2, 0, roofline.rounds(
        caps, idx, idx, np.ones(2), np.ones(2))[1])]


def test_least_time_is_the_larger_term():
    b = roofline.solve_bytes(128, 4, 1)
    assert b == 128 * 8 + 3 * 128 * 4 + 128 + 2 * 4 * 8 + 8 + 128 * 8
    assert roofline.solve_ops(128, 4, 1, 3) == 3 * (12 * 128 + 2 * 9)
    one = roofline.least_seconds([(128, 4, 1, 3)])
    assert one == max(b / 3.35e12, roofline.solve_ops(128, 4, 1, 3) / 34e12)
    assert roofline.least_seconds([(128, 4, 1, 3)] * 2) == 2 * one


def test_slice_unions_device_records_and_names_idle_gaps():
    s = devtrace.Slice(
        start_us=0.0, end_us=100.0,
        device=[("k1", 10.0, 20.0), ("k2", 15.0, 30.0), ("Memcpy HtoD", 31.0,
                                                         33.0),
                ("k1", 60.0, 70.0), ("late", 95.0, 120.0)],
        host=[("outer", 0.0, 100.0), ("sync", 35.0, 55.0), ("tiny", 1.0,
                                                             2.0)])
    assert s.busy_intervals() == [[10.0, 30.0], [31.0, 33.0], [60.0, 70.0],
                                  [95.0, 100.0]]
    assert s.busy_s() == pytest.approx(37e-6)
    assert s.window_s == pytest.approx(100e-6)
    assert len(s.kernels()) == 4
    assert s.top_device_ops()[0][0] == "late"
    gaps = dict(s.idle_gaps())
    # 0-10 and 70-95 under "outer"; 33-60 under "sync"; 30-31 short
    assert gaps["outer"] == pytest.approx(35e-6)
    assert gaps["sync"] == pytest.approx(27e-6)
    assert sum(gaps.values()) == pytest.approx(100e-6 - s.busy_s())
