"""The comparison that decides ``correct``.

Each sim the window ran is run again by the frozen reference (the numpy
``soa`` engine in ``reference/``) on the same jobs and sim seed,
and the two ``MultiSimResult`` objects are held field for field: the
simulated time, the event count and every job's ``JobSimResult`` (times,
throughput, chunk counts, costs, status, the per-edge maps). The program
states that its float64 sim equals the numpy engine bit for bit, so both
numbers compared have the limit 0:

  * ``fields_differing``: leaves of the results that are not equal (a
    leaf on one side only counts as differing);
  * ``max_rel_gap``: the widest relative gap between two numeric leaves.

The control, the program's float32 water-filling (``rate_solver="f32"``),
reads above both (``PERF.md`` has the readings).
"""

from __future__ import annotations

import dataclasses
import math

LIMITS = {"fields_differing": 0, "max_rel_gap": 0.0}


def leaves(x, path: str = "") -> dict:
    """A result's leaves by path: dataclasses, dicts and lists opened."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(leaves(v, f"{path}.{k}" if path else str(k)))
        return out
    if isinstance(x, (list, tuple)):
        out = {}
        for i, v in enumerate(x):
            out.update(leaves(v, f"{path}[{i}]"))
        return out
    return {path: x}


def _number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _same(a, b) -> bool:
    if _number(a) and _number(b):
        return a == b or (math.isnan(a) and math.isnan(b))
    return type(a) is type(b) and a == b


def _gap(a, b) -> float:
    if a == b:
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / abs(b) if b else math.inf


def compare(program, reference) -> dict:
    """``fields_differing`` and ``max_rel_gap`` of one sim's results."""
    a, b = leaves(program), leaves(reference)
    differing, gap = 0, 0.0
    for k in a.keys() | b.keys():
        if k not in a or k not in b:
            differing += 1
            continue
        if not _same(a[k], b[k]):
            differing += 1
        if _number(a[k]) and _number(b[k]):
            gap = max(gap, _gap(float(a[k]), float(b[k])))
    return {"fields_differing": differing, "max_rel_gap": gap}


def merge(readings: list[dict]) -> dict:
    """Readings of several sims as one: fields summed, the widest gap."""
    return {
        "fields_differing": sum(r["fields_differing"] for r in readings),
        "max_rel_gap": max((r["max_rel_gap"] for r in readings),
                           default=0.0),
    }


def within(reading: dict) -> bool:
    return all(reading[k] <= lim for k, lim in LIMITS.items())
