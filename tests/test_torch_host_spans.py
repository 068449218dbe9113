"""The torch sim's wall-clock spans (``obs.trace.host_span``) and the
counters beside them, on the CPU: the spans nest under one ``sim.call``
root a call and cover it; each adds to its counter whether or not the
tracer is on; and under ``torch.profiler`` each is a profiler range that
the tracer's epoch anchor puts on the profiler's clock. The card's
counters (``sim.replay_device_s``, ``sim.block_gap_s``) are held by the
``gpu`` tests of ``test_torch_cuda_kernels.py``."""

from __future__ import annotations

import gc
import statistics

import pytest

from repro_torch.core import default_topology
from repro_torch.obs import trace
from repro_torch.obs.metrics import REGISTRY
from repro_torch.transfer import simulate

from test_torch_cases import SIM_SCENARIOS, sim_scenario
from test_torch_cases import one_thread  # noqa: F401

# every span of the torch engine; the card adds the capture and replays
SPANS = ("sim.call", "sim.build", "sim.apply_due", "sim.block.eager",
         "sim.block.capture", "sim.block.replay", "sim.flags",
         "sim.cascade_seq", "sim.finalize")
# the spans every CPU run has (the sequential cascade only where a relay
# buffer fills)
CPU_SPANS = {"sim.call", "sim.build", "sim.apply_due", "sim.block.eager",
             "sim.flags", "sim.finalize"}
TOL_S = 1e-9  # float rounding of a span's end, rebased to the tracer


@pytest.fixture(scope="module")
def top():
    return default_topology()


def _traced(jobs, faults, kw, calls=1):
    tr = trace.enable(capacity=1 << 16)
    try:
        for _ in range(calls):
            simulate(jobs, faults, device="cpu", seed=0, **kw)
        return tr, trace.on_track(tr.events(), trace.HOST)
    finally:
        trace.disable()


def _covered(intervals) -> float:
    """Seconds of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


@pytest.mark.parametrize("name", SIM_SCENARIOS)
def test_spans_nest_under_one_root_a_call_and_cover_it(name, top):
    jobs, faults, kw = sim_scenario(name, top)
    _, host = _traced(jobs, faults, kw, calls=2)
    names = {e[1] for e in host}
    assert CPU_SPANS <= names <= set(SPANS)
    assert ("sim.cascade_seq" in names) == (name == "relay_buffer_1")
    assert all(e[0] == "X" and set(e[5]) == {"call"} for e in host)
    roots = {e[5]["call"]: e for e in host if e[1] == "sim.call"}
    assert len(roots) == 2  # one root a call, each with its own id
    for call, root in roots.items():
        kids = [e for e in host if e[5]["call"] == call and e is not root]
        assert {e[1] for e in kids} == names - {"sim.call"}
        start, end = root[2], root[2] + root[3]
        for e in kids:
            assert start - TOL_S <= e[2] and e[2] + e[3] <= end + TOL_S, e
        cover = _covered([(e[2], e[2] + e[3]) for e in kids])
        assert cover >= 0.95 * root[3], (cover, root[3])


@pytest.mark.parametrize("name", SIM_SCENARIOS)
def test_counters_advance_with_the_tracer_off_by_the_spans_durations(name,
                                                                      top):
    jobs, faults, kw = sim_scenario(name, top)
    counters = [f"{s}_s" for s in CPU_SPANS] + ["sim.flag_reads"]
    if name == "relay_buffer_1":
        counters.append("sim.cascade_seq_s")
    card_only = ("sim.block_gap_s", "sim.replay_device_s",
                 "sim.graph_capture_s", "sim.block.replay_s")

    def values():
        return {c: REGISTRY.counter(c).value
                for c in counters + list(card_only)}

    assert not trace.get_tracer().enabled
    before = values()
    simulate(jobs, faults, device="cpu", seed=0, **kw)
    off = {c: v - before[c] for c, v in values().items()}
    assert all(off[c] > 0 for c in counters), off
    assert all(off[c] == 0 for c in card_only), off  # no graph on the CPU

    before = values()
    _, host = _traced(jobs, faults, kw)
    on = {c: v - before[c] for c, v in values().items()}
    assert on["sim.flag_reads"] == off["sim.flag_reads"] == sum(
        e[1] == "sim.flags" for e in host)
    for c in counters:
        if c.endswith("_s"):
            spans = [e[3] for e in host if e[1] == c[:-2]]
            assert spans and on[c] == pytest.approx(sum(spans), rel=1e-12,
                                                    abs=TOL_S), c


@pytest.mark.parametrize("name", ["horizon_cut", "relay_buffer_1"])
def test_spans_are_profiler_ranges_on_the_profilers_clock(name, top):
    """Each span is a profiler range of its name (a plain operation's, so
    a profiled card run gets no device-side twin of it), and the tracer's
    epoch anchor puts the ring buffer's span on the range: inside it, to
    within 100 us, and at both ends within 100 us of it in the median (a
    span's clock reads lie inside its range, so a thread preempted
    between the two widens one span's gap, not the clocks'). The first
    call warms the profiler's own first-use costs; the second call's
    spans are compared."""
    from torch.profiler import ProfilerActivity, profile

    jobs, faults, kw = sim_scenario(name, top)
    tr = trace.enable(capacity=1 << 16)
    gc.disable()  # no collector pause inside a span's reads
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                simulate(jobs, faults, device="cpu", seed=0, **kw)
        host = trace.on_track(tr.events(), trace.HOST)
    finally:
        gc.enable()
        trace.disable()
    ranges: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in SPANS:
            assert not e.is_user_annotation(), e.name()
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    spans: dict = {}
    for e in host:
        spans.setdefault(e[1], []).append(e)
    assert set(ranges) == set(spans)
    second = max(e[5]["call"] for e in host)
    heads, tails = [], []
    for span_name, got in spans.items():
        want = sorted(ranges[span_name])
        got = sorted(got, key=lambda e: e[2])
        assert len(got) == len(want), span_name
        for e, (start, end) in zip(got, want):
            if e[5]["call"] != second:
                continue
            head = tr.epoch_ns(e[2]) - start
            tail = end - tr.epoch_ns(e[2] + e[3])
            assert head >= -100_000 and tail >= -100_000, (e, start, end)
            heads.append(abs(head))
            tails.append(abs(tail))
    assert len(heads) >= len(SPANS) - 3
    assert statistics.median(heads) <= 100_000, heads
    assert statistics.median(tails) <= 100_000, tails


def test_host_span_counts_always_and_records_only_with_the_tracer():
    c, other = REGISTRY.counter("test.phase_s"), REGISTRY.counter(
        "test.other_s")
    before = c.value
    with trace.host_span("test.phase", call=1):
        pass
    assert c.value > before and not trace.get_tracer().events()
    before = other.value
    tr = trace.enable(capacity=8)
    try:
        with trace.host_span("test.phase", counter="test.other_s", call=2):
            pass
        (ev,) = tr.events()
    finally:
        trace.disable()
    assert ev[0] == "X" and ev[1] == "test.phase" and ev[4] == trace.HOST
    assert ev[5] == {"call": 2}
    assert other.value - before == pytest.approx(ev[3], abs=TOL_S)
