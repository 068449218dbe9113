"""Skytrace for the port: the metrics registry, the ring-buffer tracer and
its exports (copies of the reference package's ``obs/``). ``python -m
repro_torch.obs`` runs a seeded chaos scenario and exports its
(byte-deterministic) sim trace.
"""

from __future__ import annotations

from .export import text_timeline, to_chrome_trace, trace_json, write_trace
from .metrics import Counter, MetricsRegistry, REGISTRY, get_registry
from .trace import Tracer, disable, enable, get_tracer

__all__ = [
    "Counter",
    "MetricsRegistry",
    "REGISTRY",
    "Tracer",
    "disable",
    "enable",
    "get_registry",
    "get_tracer",
    "text_timeline",
    "to_chrome_trace",
    "trace_json",
    "write_trace",
]
