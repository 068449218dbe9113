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


class Gauge:
    """Last-written value; absent from snapshots until first ``set``."""

    __slots__ = ("name", "_value", "_set", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._set = False
        self._lock = threading.Lock()

    @property
    def value(self):
        return self._value

    def set(self, v) -> None:
        with self._lock:
            self._value = v
            self._set = True

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0
            self._set = False

    def _snapshot(self):
        return self._value if self._set else None


class Histogram:
    """Count / total / min / max summary of observed values."""

    __slots__ = ("name", "count", "total", "min", "max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._zero()

    def _zero(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def reset(self) -> None:
        with self._lock:
            self._zero()

    def _snapshot(self):
        if not self.count:
            return None
        return {
            "count": self.count,
            "total": self.total,
            "min": self.min,
            "max": self.max,
        }


class MetricsRegistry:
    """Get-or-create home for every named instrument in the process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._instruments.get(name)
            if m is None:
                m = cls(name)
                self._instruments[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

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
