"""Skytrace for the port: the metrics registry and the ring-buffer tracer
(copies of the reference package's ``obs/metrics.py`` and ``obs/trace.py``).
"""

from __future__ import annotations

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    get_registry,
)
from .trace import Tracer, disable, enable, get_tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "Tracer",
    "disable",
    "enable",
    "get_registry",
    "get_tracer",
]
