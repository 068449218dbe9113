# Frozen copy of src/repro/obs/trace.py at commit 9de379d4b486;
# only the imports changed.
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

The default tracer is a shared no-op singleton with ``enabled = False``.
Instrumented hot paths capture ``tr = get_tracer()`` once and guard
every emission with ``if tr.enabled:`` so disabled-mode overhead is one
attribute read (unmeasurable on ``flowsim_bench`` — gated by
``BENCH_obs.json``).
"""

from __future__ import annotations

import time
from collections import deque

DEFAULT_CAPACITY = 1 << 16

# Event tuples: (phase, name, ts_s, dur_s, track, args-or-None) with
# Chrome-trace phases — "X" complete span, "i" instant, "C" counter.


class Tracer:
    enabled = True

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self._wall0 = time.perf_counter()

    def now_wall(self) -> float:
        """Wall seconds since this tracer was created (perf_counter)."""
        return time.perf_counter() - self._wall0

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
