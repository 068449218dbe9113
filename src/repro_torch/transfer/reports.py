"""One report protocol for every outcome dataclass.

``JobReport`` / ``ServiceReport`` (executor), ``GatewayReport`` /
``MulticastGatewayReport`` (real-bytes data plane),
``CalibratedServiceReport`` (calibration loop) and ``FleetReport``
(fleet control plane) each grew their own field spellings — per-edge
telemetry was ``per_edge_bytes``/``per_edge_seconds`` on gateways but
``per_edge_gb`` on sim results, multicast outcomes were ``per_dest`` here
and ``per_dst_delivered`` there. Consumers (``benchmarks/compare.py``,
``fleet_bench``) now read ONE shape:

  * ``to_dict()`` — a plain-JSON dict with a ``kind`` tag and canonical
    key names: ``per_edge`` is ``{"a->b": {"gb", "seconds", "gbps"}}``,
    per-destination breakdowns are ``per_dst``;
  * ``summary()`` — a one-line human rendering of the headline fields
    (each class declares them in ``_summary_keys``).

The mixin is field-free so dataclasses can inherit it without changing
their layout; legacy attributes stay (the protocol normalizes names at
the boundary instead of breaking every caller at once).
"""

from __future__ import annotations


def edge_key(edge) -> str:
    """Canonical spelling of a region-pair edge: ``"a->b"``.

    Accepts (index, index) or (key, key) pairs — whatever the producer
    tracked; the dict form is for humans and JSON, not for joins."""
    a, b = edge
    return f"{a}->{b}"


def per_edge_dict(bytes_map, seconds_map) -> dict:
    """Normalize the two parallel per-edge maps into the canonical shape."""
    out: dict = {}
    for e, nbytes in (bytes_map or {}).items():
        secs = float((seconds_map or {}).get(e, 0.0))
        gb = float(nbytes) / 1e9
        out[edge_key(e)] = {
            "gb": gb,
            "seconds": secs,
            "gbps": (gb * 8.0 / secs) if secs > 1e-9 else 0.0,
        }
    return out


def _fmt(v) -> str:
    if isinstance(v, bool) or v is None:
        return str(v)
    if isinstance(v, float):
        return f"{v:.3g}"
    return str(v)


class Report:
    """Field-free mixin: the ``to_dict()`` / ``summary()`` protocol.

    Subclasses set ``kind`` (the dict's type tag), implement
    ``_payload()`` (their fields under canonical names), and list their
    headline keys in ``_summary_keys``. A class that names registry
    planes in ``_metrics_prefixes`` (``("gateway.",)`` etc.) gets a
    ``metrics`` section in its dict: the matching non-zero instruments
    from ``repro_torch.obs.metrics`` at render time."""

    kind: str = "report"
    _summary_keys: tuple = ()
    _metrics_prefixes: tuple = ()

    def _payload(self) -> dict:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {"kind": self.kind, **self._payload()}
        if self._metrics_prefixes:
            # lazy import: reports is imported by every plane the
            # registry instruments, so a top-level import would cycle
            from repro_torch.obs.metrics import get_registry

            metrics = get_registry().snapshot(self._metrics_prefixes)
            if metrics:
                d["metrics"] = metrics
        return d

    def summary(self) -> str:
        d = self.to_dict()
        parts = " ".join(
            f"{k}={_fmt(d[k])}" for k in self._summary_keys if k in d
        )
        return f"[{self.kind}] {parts}".rstrip()
