"""Process-local metrics registry.

One named instrument per fact the repo used to track ad hoc: the LP
structure-build counter that every zero-re-assembly test pins, leaked
gateway workers, probe spend, dedup hits, breaker trips, epoch rolls.
Instruments are get-or-create by name, so instrumentation sites can hold
a module-level reference (``_trips = REGISTRY.counter("breaker.trips")``)
and tests can read the same instrument back by name.

Names are dotted, ``<plane>.<fact>`` (``gateway.workers_leaked``,
``planner.struct_builds``, ``calibrate.probe_usd``); report classes pick
their ``metrics`` section out of the registry by plane prefix.

``reset()`` zeroes every instrument IN PLACE — cached references stay
valid — which is what the test-suite conftest fixture calls between
tests.
"""

from __future__ import annotations

import threading


class Counter:
    """Monotonically increasing value (int or float increments)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    @property
    def value(self):
        return self._value

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def _snapshot(self):
        return self._value if self._value else None


class MetricsRegistry:
    """Get-or-create home for every named instrument in the process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._instruments.get(name)
            if m is None:
                m = self._instruments[name] = Counter(name)
            return m

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self, prefixes: tuple = ()) -> dict:
        """Name -> value for every non-empty instrument, sorted by name.

        ``prefixes`` filters to the given dotted-name prefixes (a report's
        plane selection); empty means everything."""
        with self._lock:
            items = sorted(self._instruments.items())
        out: dict = {}
        for name, m in items:
            if prefixes and not any(name.startswith(p) for p in prefixes):
                continue
            v = m._snapshot()
            if v is not None:
                out[name] = v
        return out

    def reset(self) -> None:
        """Zero every instrument in place (cached references stay live)."""
        with self._lock:
            items = list(self._instruments.values())
        for m in items:
            m.reset()


# The process-local default registry every instrumentation site uses.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
