"""The readers of the program's host spans and counters: their values
from given counters, and nothing, without raising, where the program has
no such span or counter (all read 0)."""

import pytest

from skybench import cells, harness

SPAN_METRICS = ("window_idle_share", "state_build_ms_per_sim",
                "eager_block_ms_per_sim", "host_gap_us_per_block")


def _readings(counters: dict) -> harness.Readings:
    return harness.Readings(
        setup_s=10.0, window_s=50.0, window_sims=10, window_events=200_000,
        window_chunks=200_000, window_counters=counters)


def _counters(value) -> dict:
    names = {c for n in SPAN_METRICS
             for c in cells.metric_reader(n).COUNTERS}
    return {c: value for c in names}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_the_counters_reads_nothing(name):
    assert cells.metric_reader(name).read(_readings(_counters(0))) is None


def test_values_from_the_counters():
    c = {"sim.replay_device_s": 45.0, "sim.build_s": 0.05,
         "sim.block.eager_s": 2.0, "sim.block_gap_s": 1.5,
         "sim.flag_reads": 3_000}
    r = _readings(c)

    def read(n):
        return cells.metric_reader(n).read(r)

    assert read("window_idle_share") == pytest.approx(10.0)
    assert read("state_build_ms_per_sim") == pytest.approx(5.0)
    assert read("eager_block_ms_per_sim") == pytest.approx(200.0)
    assert read("host_gap_us_per_block") == pytest.approx(500.0)
