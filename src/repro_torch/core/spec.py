"""PlanSpec — the single planning-request shape behind ``Planner.plan``.

Eight historically-grown entry points (``plan_cost_min``, ``plan_tput_max``,
their multicast twins, the two throughput bounds and the two Pareto sweeps)
accreted inconsistent kwargs. A ``PlanSpec`` names the request once:

  * ``objective`` — what to optimize: ``"cost_min"`` (minimize $ subject to
    a throughput floor), ``"tput_max"`` (maximize throughput under a cost
    ceiling), ``"max_throughput"`` (LP capacity bound, returns a float),
    ``"pareto"`` / ``"pareto_fast"`` (frontier sweeps, return ParetoPoints).
  * ``dst`` vs ``dsts`` — exactly one is set; ``dsts`` selects the
    multicast (one-to-many envelope) formulation.
  * the shared constraint vocabulary — ``robustness`` (belief LCB z),
    ``degraded_links`` / ``vm_caps`` (fault cuts), ``tput_scale`` (explicit
    per-link grid scale), ``agg_scale`` (per-link aggregate share caps, the
    fleet controller's fair-share rows) — all of which ride CACHED
    LPStructures as extra rows; no spec field ever re-assembles an LP.

The spec is frozen: mapping arguments are normalized to sorted item tuples
at construction (so two specs built from equal dicts compare equal), and
array fields are kept as-is (specs carrying grids are not hashable, which
is fine — they are request objects, not cache keys).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence

import numpy as np

OBJECTIVES = ("cost_min", "tput_max", "max_throughput", "pareto", "pareto_fast")


def _freeze_items(m) -> tuple | None:
    """dict -> sorted item tuple; tuples pass through; None stays None."""
    if m is None:
        return None
    if isinstance(m, Mapping):
        return tuple(sorted(m.items()))
    return tuple(m)


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """One planning request. See module docstring for the vocabulary."""

    objective: str
    src: str
    dst: str | None = None
    dsts: tuple[str, ...] | None = None
    volume_gb: float = 0.0
    # cost_min: the throughput floor (scalar, or per-destination sequence
    # for multicast — zeros drop a destination from the trees)
    tput_goal_gbps: float | tuple[float, ...] = 0.0
    # tput_max: the price ceiling the fastest plan must fit under
    cost_ceiling_per_gb: float | None = None
    # sweep resolution for tput_max / pareto objectives (None = per-
    # objective default: 40 unicast, 12 multicast, 64 pareto_fast)
    n_samples: int | None = None
    mode: str | None = None  # None = planner default ("relaxed" or "exact")
    backend: str = "numpy"  # "numpy" | "torch" (batched round-down sweep)
    robustness: float = 0.0  # belief LCB z (needs a belief on the Planner)
    # fault cuts, full-topology indices: {(src_region, dst_region): phi}
    # and {region: vm_ceiling} — normalized to sorted item tuples
    degraded_links: tuple[tuple[tuple[int, int], float], ...] | None = None
    vm_caps: tuple[tuple[int, float], ...] | None = None
    tput_scale: np.ndarray | None = None  # explicit full-grid [V,V] scale
    # per-link aggregate share caps, full-grid [V,V] (non-finite =
    # uncapped): the fleet's weighted fair shares as scale-cut rows
    agg_scale: np.ndarray | None = None

    def __post_init__(self):
        if self.objective not in OBJECTIVES:
            raise ValueError(
                f"unknown objective {self.objective!r} (one of {OBJECTIVES})"
            )
        if (self.dst is None) == (self.dsts is None):
            raise ValueError("exactly one of dst / dsts must be set")
        if self.dsts is not None:
            if self.objective in ("pareto", "pareto_fast"):
                raise ValueError(f"{self.objective} is unicast-only (use dst)")
            object.__setattr__(self, "dsts", tuple(self.dsts))
            if not self.dsts:
                raise ValueError("dsts must be non-empty")
        tg = self.tput_goal_gbps
        if isinstance(tg, np.ndarray):
            tg = float(tg) if tg.ndim == 0 else tuple(float(g) for g in tg)
        elif isinstance(tg, Sequence):
            tg = tuple(float(g) for g in tg)
        else:
            tg = float(tg)
        object.__setattr__(self, "tput_goal_gbps", tg)
        if self.objective == "tput_max" and self.cost_ceiling_per_gb is None:
            raise ValueError("tput_max needs cost_ceiling_per_gb")
        object.__setattr__(
            self, "degraded_links", _freeze_items(self.degraded_links)
        )
        object.__setattr__(self, "vm_caps", _freeze_items(self.vm_caps))

    # ------------------------------------------------------------- accessors
    @property
    def multicast(self) -> bool:
        return self.dsts is not None

    @property
    def degraded_links_map(self) -> dict[tuple[int, int], float] | None:
        return dict(self.degraded_links) if self.degraded_links else None

    @property
    def vm_caps_map(self) -> dict[int, float] | None:
        return dict(self.vm_caps) if self.vm_caps else None

    def goals(self) -> np.ndarray | float:
        """Multicast floors as an array; the scalar unicast floor as-is."""
        if self.multicast:
            g = np.asarray(self.tput_goal_gbps, dtype=float)
            if g.ndim == 0:
                g = np.full(len(self.dsts), float(g))
            return g
        return float(self.tput_goal_gbps)
