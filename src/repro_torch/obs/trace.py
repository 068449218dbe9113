"""Bounded, deterministic event tracer.

A :class:`Tracer` records events into a ``deque(maxlen=capacity)`` ring
buffer — appends are GIL-atomic, so gateway worker threads emit without
a lock, and an unbounded run can never exhaust memory (old events fall
off the front).

Event timebases, by track:

  * ``sim`` — sim-time seconds from the simulators' own clocks. Two runs
    with the same seed produce byte-identical traces, and ``flowsim`` /
    ``flowsim_ref`` emit identical sim-event streams (pinned by
    tests/test_obs.py).
  * ``planner`` / ``gateway`` / ``service`` wall spans —
    ``time.perf_counter()`` re-based to the tracer's start
    (``now_wall``); legal under SKY001, nondeterministic by nature.
  * ``host`` — the port's own phases (``host_span``: the torch sim's
    state build, blocks, flag reads, capture), on the same wall clock.
    The tracer's anchor, ``time.time_ns()`` read beside its start, puts
    these on the clock ``torch.profiler`` stamps (unix-epoch ns):
    ``epoch_ns(ts_s)``.

The default tracer is a shared no-op singleton with ``enabled = False``.
Instrumented hot paths capture ``tr = get_tracer()`` once and guard
every emission with ``if tr.enabled:`` so disabled-mode overhead is one
attribute read (unmeasurable on ``flowsim_bench`` — gated by
``BENCH_obs.json``).
"""

from __future__ import annotations

import time
from collections import deque

import torch

from .metrics import REGISTRY

DEFAULT_CAPACITY = 1 << 16
HOST = "host"  # the track of host_span's events

# Event tuples: (phase, name, ts_s, dur_s, track, args-or-None) with
# Chrome-trace phases — "X" complete span, "i" instant, "C" counter.


class Tracer:
    enabled = True

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self._wall0 = time.perf_counter()
        self._epoch0_ns = time.time_ns()

    def now_wall(self) -> float:
        """Wall seconds since this tracer was created (perf_counter)."""
        return time.perf_counter() - self._wall0

    def epoch_ns(self, ts_s: float) -> int:
        """A wall track's ``ts_s`` as unix-epoch nanoseconds, the clock of
        ``torch.profiler``'s records."""
        return self._epoch0_ns + round(ts_s * 1e9)

    def instant(self, name: str, ts_s: float, track: str = "sim", **args):
        self._buf.append(("i", name, float(ts_s), 0.0, track, args or None))

    def span(self, name: str, ts_s: float, dur_s: float,
             track: str = "sim", **args):
        self._buf.append(
            ("X", name, float(ts_s), float(dur_s), track, args or None)
        )

    def sample(self, name: str, ts_s: float, value, track: str = "sim"):
        self._buf.append(
            ("C", name, float(ts_s), 0.0, track, {"value": value})
        )

    def events(self) -> list:
        return list(self._buf)

    def clear(self) -> None:
        self._buf.clear()

    def __len__(self) -> int:
        return len(self._buf)


class _NullTracer(Tracer):
    """The disabled tracer: every emission is a no-op."""

    enabled = False

    def __init__(self):
        super().__init__(capacity=0)

    def instant(self, name, ts_s, track="sim", **args):
        pass

    def span(self, name, ts_s, dur_s, track="sim", **args):
        pass

    def sample(self, name, ts_s, value, track="sim"):
        pass


_NULL = _NullTracer()
_CURRENT: list[Tracer] = [_NULL]  # one-slot box: swap, never rebind


def get_tracer() -> Tracer:
    """The process-current tracer (the no-op singleton when disabled)."""
    return _CURRENT[0]


def enable(capacity: int = DEFAULT_CAPACITY) -> Tracer:
    """Install (and return) a fresh recording tracer."""
    tr = Tracer(capacity=capacity)
    _CURRENT[0] = tr
    return tr


def disable() -> None:
    """Restore the shared no-op tracer."""
    _CURRENT[0] = _NULL


def on_track(events, track: str = "sim") -> list:
    """The events of one track, in the order recorded."""
    return [e for e in events if e[4] == track]


class host_span:
    """``with host_span("sim.build", call=7):`` times a phase of the
    program on the wall clock, with one pair of ``perf_counter`` reads.

    Always: adds the seconds to the ``REGISTRY`` counter ``counter``
    (default: the span's name + ``_s``, so ``sim.build`` -> ``sim.build_s``).
    With the tracer on: appends an ``"X"`` event on the ``host`` track,
    carrying ``args`` (a parent span is the one that encloses it in time
    and carries the same ``args``). With ``torch.profiler`` on: also opens
    a profiler range of the span's name around the same interval, so the
    profiled trace names the host's phases. The range is a plain
    operation's (``_RecordFunctionFast``), not a user annotation: a user
    annotation that encloses launches gets a device-side twin record
    spanning their kernels, which would read as device activity."""

    __slots__ = ("name", "counter", "args", "t0", "rf")

    def __init__(self, name: str, counter: str | None = None, **args):
        self.name = name
        self.counter = counter or name + "_s"
        self.args = args

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        REGISTRY.counter(self.counter).inc(dur)
        tr = _CURRENT[0]
        if tr.enabled:
            tr.span(self.name, self.t0 - tr._wall0, dur, track=HOST,
                    **self.args)
        return False
