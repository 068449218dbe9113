"""Render a tracer's ring buffer: Chrome-trace JSON or a text timeline.

Chrome-trace output loads directly in Perfetto (ui.perfetto.dev) or
``chrome://tracing``. Timestamps quantize to integer microseconds at
export — the sims' float clocks can diverge at ulp level between the
vectorized and reference loops (different summation orders), and the
quantization is what makes their traces byte-identical.

``trace_json`` serializes with sorted keys and no whitespace so that the
same event stream always produces the same bytes (the cross-process
determinism pin in tests/test_obs.py).
"""

from __future__ import annotations

import json


def _us(ts_s: float) -> int:
    return int(round(ts_s * 1e6))


def to_chrome_trace(events) -> dict:
    """Chrome-trace (trace-event format) dict for a list of event tuples.

    Tracks become tids in order of first appearance, each announced with
    a ``thread_name`` metadata record so Perfetto labels the lanes."""
    tids: dict[str, int] = {}
    rows = []
    for ph, name, ts_s, dur_s, track, args in events:
        tid = tids.setdefault(track, len(tids) + 1)
        row = {"name": name, "ph": ph, "ts": _us(ts_s), "pid": 1, "tid": tid}
        if ph == "X":
            row["dur"] = max(_us(dur_s), 1)
        if args:
            row["args"] = args
        rows.append(row)
    meta = [
        {
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": track},
        }
        for track, tid in tids.items()
    ]
    return {"traceEvents": meta + rows, "displayTimeUnit": "ms"}


def trace_json(events) -> str:
    """Canonical (byte-stable) JSON serialization of a trace."""
    return json.dumps(
        to_chrome_trace(events), sort_keys=True, separators=(",", ":")
    )


def write_trace(events, path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(trace_json(events))
        fh.write("\n")


def _fmt_args(args: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in args.items())


def text_timeline(events, limit: int | None = None) -> str:
    """Human-readable one-line-per-event rendering, time-ordered as
    recorded. ``limit`` keeps only the last N events."""
    evs = list(events)
    if limit is not None:
        evs = evs[-limit:]
    lines = []
    for ph, name, ts_s, dur_s, track, args in evs:
        stamp = f"{ts_s * 1e3:12.3f}ms"
        tail = f" {_fmt_args(args)}" if args else ""
        if ph == "X":
            lines.append(
                f"{stamp} [{track}] {name} +{dur_s * 1e3:.3f}ms{tail}"
            )
        else:
            lines.append(f"{stamp} [{track}] {name}{tail}")
    return "\n".join(lines)
