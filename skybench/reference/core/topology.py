# Frozen copy of src/repro/core/topology.py at commit 9de379d4b486;
# only the imports changed.
"""Region topology: the flow-network graph over which Skyplane plans (paper §3.1).

Nodes are cloud regions; the two grids attached to the graph are exactly the
paper's inputs:
  * throughput grid  — achievable TCP goodput (Gbps) between each ordered region
    pair, measured at ``limit_conn`` parallel connections (paper §3.2, Fig. 3).
  * price grid       — egress $/GB between each ordered region pair (paper §2).

Per-region constants mirror Table 1: per-VM ingress/egress limits (Gbps), VM
price ($/s) and the per-region VM service limit.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

GBIT_PER_GB = 8.0  # egress prices are $/GB; flows are Gbit/s


@dataclasses.dataclass(frozen=True)
class Region:
    """A cloud region (one node of the overlay graph)."""

    provider: str  # "aws" | "azure" | "gcp"
    name: str  # provider-native region name, e.g. "us-west-2"
    continent: str  # "na" | "sa" | "eu" | "ap" | "af" | "oc" | "me"
    lat: float
    lon: float

    @property
    def key(self) -> str:
        return f"{self.provider}:{self.name}"

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return self.key


@dataclasses.dataclass
class Topology:
    """The overlay flow network. All arrays are ordered like ``regions``."""

    regions: list[Region]
    tput: np.ndarray  # [V,V] Gbps at limit_conn connections; 0 on diagonal
    price_egress: np.ndarray  # [V,V] $/GB for traffic u->v; 0 on diagonal
    price_vm: np.ndarray  # [V] $/s per VM
    limit_ingress: np.ndarray  # [V] Gbps per VM
    limit_egress: np.ndarray  # [V] Gbps per VM
    rtt_ms: np.ndarray | None = None  # [V,V] used by the RON baseline
    limit_conn: int = 64  # max TCP connections per VM (paper §4.2)
    limit_vm: int = 8  # per-region VM service limit (paper §7.2 uses 8)

    def __post_init__(self) -> None:
        v = len(self.regions)
        assert self.tput.shape == (v, v), self.tput.shape
        assert self.price_egress.shape == (v, v)
        assert self.price_vm.shape == (v,)
        assert self.limit_ingress.shape == (v,)
        assert self.limit_egress.shape == (v,)
        self._index = {r.key: i for i, r in enumerate(self.regions)}
        # derived-data caches (edge lists, LP structures). Keyed per instance:
        # mutate the grids only by building a new Topology (dataclasses.replace
        # re-runs __post_init__ and starts these fresh). The grids themselves
        # are frozen COPIES — an in-place write to ``tput`` after an
        # LPStructure was cached would silently desynchronize every cached
        # constraint matrix, so mutation raises and ``with_tput`` is the
        # sanctioned path. Copying first keeps the freeze from leaking into
        # arrays the caller still owns (already-frozen inputs, e.g. from
        # dataclasses.replace, are shared as-is).
        for name in ("tput", "price_egress", "price_vm",
                     "limit_ingress", "limit_egress", "rtt_ms"):
            arr = getattr(self, name)
            if arr is not None and arr.flags.writeable:
                arr = arr.copy()
                arr.setflags(write=False)
                setattr(self, name, arr)
        self._edge_cache: dict = {}
        self._lp_struct_cache: dict = {}

    def with_tput(
        self,
        tput: np.ndarray | None = None,
        *,
        scale: np.ndarray | float | None = None,
    ) -> "Topology":
        """Copy-on-write grid swap: a NEW Topology with ``tput`` (or the
        current grid times ``scale``) and fresh derived-data caches.

        This is the only sanctioned way to change a topology's throughput
        grid — the arrays are frozen in ``__post_init__`` because planner
        caches (edge lists, LP structures) key off topology *identity* and
        an in-place write would poison them. The calibration plane uses
        this for both sides of its split view: the drift model's
        time-indexed true grids and the belief's estimated grid."""
        if (tput is None) == (scale is None):
            raise ValueError("pass exactly one of tput= or scale=")
        if tput is None:
            new = self.tput * scale
        else:
            new = np.array(tput, dtype=float, copy=True)
        new.setflags(write=False)  # already a private copy: freeze directly
        return dataclasses.replace(self, tput=new)

    # ------------------------------------------------------------------ utils
    @property
    def num_regions(self) -> int:
        return len(self.regions)

    def index(self, region: str | Region) -> int:
        key = region.key if isinstance(region, Region) else region
        return self._index[key]

    def keys(self) -> list[str]:
        return [r.key for r in self.regions]

    def subgraph(self, keep: Sequence[int]) -> "Topology":
        """Topology restricted to region indices ``keep`` (order preserved)."""
        keep = list(keep)
        ix = np.asarray(keep, dtype=np.int64)
        return Topology(
            regions=[self.regions[i] for i in keep],
            tput=self.tput[np.ix_(ix, ix)].copy(),
            price_egress=self.price_egress[np.ix_(ix, ix)].copy(),
            price_vm=self.price_vm[ix].copy(),
            limit_ingress=self.limit_ingress[ix].copy(),
            limit_egress=self.limit_egress[ix].copy(),
            rtt_ms=None if self.rtt_ms is None else self.rtt_ms[np.ix_(ix, ix)].copy(),
            limit_conn=self.limit_conn,
            limit_vm=self.limit_vm,
        )

    def candidate_subgraph(
        self, src: str, dst: str, max_relays: int = 10
    ) -> tuple["Topology", int, int]:
        """Prune to {src, dst} + the ``max_relays`` most promising relays.

        Relays are ranked by the bottleneck throughput of the two-hop path
        src->r->dst (the quantity RON's throughput heuristic optimizes), which
        upper-bounds the usefulness of a region as a relay. Keeps the MILP tiny
        (paper §5: "solved in under 5 seconds") without excluding any relay the
        optimum could plausibly use.
        """
        s, t = self.index(src), self.index(dst)
        v = self.num_regions
        scores = np.minimum(self.tput[s, :], self.tput[:, t])
        scores[[s, t]] = -np.inf
        order = np.argsort(-scores)
        relays = [int(i) for i in order[:max_relays] if np.isfinite(scores[i])]
        keep = [s, t] + relays
        sub = self.subgraph(keep)
        return sub, 0, 1

    def edge_list(
        self, src_idx: int | None = None, dst_idx: int | None = None
    ) -> list[tuple[int, int]]:
        """Directed edges with nonzero capacity. Drops edges into the source
        and out of the destination (never useful for a single s->t job).

        Cached per (src_idx, dst_idx); callers must treat the result as
        read-only.
        """
        key = (src_idx, dst_idx)
        cached = self._edge_cache.get(key)
        if cached is not None:
            return cached
        mask = self.tput > 0
        np.fill_diagonal(mask, False)
        if src_idx is not None:
            mask[:, src_idx] = False
        if dst_idx is not None:
            mask[dst_idx, :] = False
        edges = [(int(u), int(w)) for u, w in np.argwhere(mask)]
        self._edge_cache[key] = edges
        return edges


def haversine_km(lat1, lon1, lat2, lon2) -> float:
    """Great-circle distance, used to synthesize RTTs for the embedded grid."""
    r = 6371.0
    p1, p2 = np.radians(lat1), np.radians(lat2)
    dp = p2 - p1
    dl = np.radians(lon2 - lon1)
    a = np.sin(dp / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
    return float(2 * r * np.arcsin(np.sqrt(a)))
