"""Deterministic drift model: the TRUE topology as a function of time.

The paper measures its throughput grid once, offline (§3.2), and the
planner treats it as ground truth. Real inter-region goodput drifts away
from any static profile within hours (cross-cloud interconnect studies),
so the calibration plane splits the world in two:

  * the **believed** topology — what the planner sees (calibrate.BeliefGrid);
  * the **true** topology — what the data plane actually delivers, produced
    here by layering three deterministic processes on a base grid:

      1. slow multiplicative drift  — per-link log-factor, a sum of two
         seeded sinusoids with incommensurate periods (smooth, bounded,
         zero-mean in log space);
      2. diurnal waves              — a shared-period, per-link-phase
         utilization cycle (links sag at their local peak hours);
      3. step-change incidents      — rare interconnect events that slam a
         link to ``severity`` of its drifted value for a bounded window
         (the failure mode that stalls a static plan mid-transfer).

Everything is a pure function of (seed, t): ``tput_at(t)`` is bitwise
reproducible at arbitrary query times and across processes — no hidden RNG
state advances between calls, so simulators, probes and tests can sample
the same instant independently and agree.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import Topology


@dataclasses.dataclass(frozen=True)
class Incident:
    """A step-change interconnect event on one directed link: from
    ``t_start_s`` for ``duration_s``, the link runs at ``severity`` of its
    drifted capacity (0 < severity < 1; e.g. 0.08 = a brown-out to 8%)."""

    src: int  # region index
    dst: int
    t_start_s: float
    duration_s: float
    severity: float

    def active_at(self, t_s: float) -> bool:
        return self.t_start_s <= t_s < self.t_start_s + self.duration_s


class DriftModel:
    """Time-indexed true grid over a base :class:`Topology`.

    Static per-link parameters (sinusoid amplitudes/periods/phases, the
    incident schedule) are drawn ONCE from ``numpy.random.default_rng(seed)``
    at construction; after that every query is a pure function of time.

    ``drift_sigma`` bounds the slow drift (each sinusoid's log-amplitude is
    uniform in [sigma/4, sigma]); ``diurnal_amp`` the day-cycle sag;
    ``day_s`` the cycle period (set it to seconds-scale values in tests to
    make the wave observable inside a short transfer). ``n_incidents``
    random incidents are scheduled over ``incident_horizon_s`` on links
    with positive base throughput, or pass an explicit ``incidents`` list
    to script a scenario (e.g. "kill the stale plan's trunk at t=5s").
    """

    def __init__(
        self,
        base: Topology,
        *,
        seed: int = 0,
        drift_sigma: float = 0.12,
        drift_period_s: tuple[float, float] = (1800.0, 7200.0),
        diurnal_amp: float = 0.06,
        day_s: float = 86400.0,
        incidents: list[Incident] | None = None,
        n_incidents: int = 0,
        incident_horizon_s: float = 3600.0,
        incident_duration_s: tuple[float, float] = (60.0, 600.0),
        incident_severity: tuple[float, float] = (0.05, 0.35),
        clip: tuple[float, float] = (0.02, 2.0),
    ):
        self.base = base
        self.seed = int(seed)
        v = base.num_regions
        self._mask = np.asarray(base.tput) > 0
        self._clip = (float(clip[0]), float(clip[1]))
        rng = np.random.default_rng(self.seed)

        # slow drift: log-factor a1*sin(2pi t/p1 + f1) + a2*sin(2pi t/p2 + f2)
        lo, hi = drift_period_s
        self._amp1 = rng.uniform(drift_sigma / 4.0, drift_sigma, (v, v))
        self._amp2 = rng.uniform(drift_sigma / 4.0, drift_sigma, (v, v))
        self._per1 = rng.uniform(lo, hi, (v, v))
        # sqrt(2)-detuned so the two waves never phase-lock (quasi-periodic)
        self._per2 = rng.uniform(lo, hi, (v, v)) * np.sqrt(2.0)
        self._ph1 = rng.uniform(0.0, 2.0 * np.pi, (v, v))
        self._ph2 = rng.uniform(0.0, 2.0 * np.pi, (v, v))

        # diurnal: shared period, per-link phase and per-link depth
        self._day_s = float(day_s)
        self._damp = diurnal_amp * rng.uniform(0.5, 1.0, (v, v))
        self._dph = rng.uniform(0.0, 2.0 * np.pi, (v, v))

        if incidents is not None:
            self.incidents = list(incidents)
        else:
            self.incidents = []
            links = np.argwhere(self._mask)
            for _ in range(int(n_incidents)):
                a, b = links[int(rng.integers(len(links)))]
                self.incidents.append(Incident(
                    src=int(a), dst=int(b),
                    t_start_s=float(rng.uniform(0.0, incident_horizon_s)),
                    duration_s=float(rng.uniform(*incident_duration_s)),
                    severity=float(rng.uniform(*incident_severity)),
                ))

    # ------------------------------------------------------------------ query
    def factor_at(self, t_s: float) -> np.ndarray:
        """[V,V] multiplicative factor true/base at time ``t_s`` — pure in t."""
        t = float(t_s)
        two_pi = 2.0 * np.pi
        log_f = (
            self._amp1 * np.sin(two_pi * t / self._per1 + self._ph1)
            + self._amp2 * np.sin(two_pi * t / self._per2 + self._ph2)
        )
        f = np.exp(log_f) * (
            1.0 - self._damp * (0.5 + 0.5 * np.sin(
                two_pi * t / self._day_s + self._dph
            ))
        )
        for inc in self.incidents:
            if inc.active_at(t):
                f[inc.src, inc.dst] *= inc.severity
        f = np.clip(f, self._clip[0], self._clip[1])
        return np.where(self._mask, f, 0.0)

    def tput_at(self, t_s: float) -> np.ndarray:
        """The true [V,V] throughput grid (Gbps) at time ``t_s``."""
        return np.asarray(self.base.tput) * self.factor_at(t_s)

    def link_gbps(self, src: int, dst: int, t_s: float) -> float:
        return float(self.tput_at(t_s)[src, dst])

    def topology_at(self, t_s: float) -> Topology:
        """A fresh Topology carrying the true grid at ``t_s`` (copy-on-write
        — prices, caps and region identities are the base's)."""
        return self.base.with_tput(self.tput_at(t_s))

    def incidents_active(self, t_s: float) -> list[Incident]:
        return [i for i in self.incidents if i.active_at(t_s)]
