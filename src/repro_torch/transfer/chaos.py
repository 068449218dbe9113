"""Chaos plane: seeded correlated-fault scenario generation.

Real incidents are correlated, not the single scripted ``LinkDegrade`` /
``VMFailure`` the fault tests throw: a region outage takes down every VM
*and* every link touching the region at once; a provider brownout saps an
entire provider's interconnect; a gray failure silently delivers a
fraction of the believed rate with no failure signal; a flapping link
cycles down/up faster than any static re-plan can follow.

This module composes those archetypes into the primitive event stream both
simulators execute (``events.LinkDegrade`` / ``GrayFailure`` /
``LinkRestore`` / ``VMFailure``), so the chunk-for-chunk parity between
``flowsim.simulate_multi`` and the ``flowsim_ref`` oracle extends to every
chaos scenario for free — archetypes are pure compile-time sugar, the
event loops never learn new physics.

Like ``calibrate.drift.DriftModel``, a :class:`ChaosScenario` draws every
random choice ONCE at construction from ``numpy.random.default_rng(seed)``
— the archetype list and the compiled event stream are pure functions of
the constructor arguments, bitwise reproducible across processes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .events import GrayFailure, LinkDegrade, LinkRestore, VMFailure

# Degrade factors stay strictly positive so every down-edge has an exact
# multiplicative inverse for its restore (factor * 1/factor compounds back
# to the pre-event rate up to float rounding — identically in both sims).
SEVERITY_FLOOR = 0.02

# More VMs than any plan provisions in one region: a RegionOutage kill
# with this count takes out every gateway the job has there.
_ALL_VMS = 1_000_000


# ------------------------------------------------------------- archetypes
@dataclasses.dataclass(frozen=True)
class RegionOutage:
    """At ``t_s`` the region goes dark for ``duration_s``: every job loses
    all its VMs there (permanently — instances do not resurrect, replacing
    quota is not modelled) and every link touching the region collapses to
    ``severity`` of its current capacity until the outage lifts."""

    t_s: float
    region: int  # region index
    duration_s: float
    severity: float = SEVERITY_FLOOR


@dataclasses.dataclass(frozen=True)
class ProviderBrownout:
    """Provider-wide capacity brownout: every link whose endpoint region
    belongs to ``provider`` (the ``"aws"`` of ``"aws:us-east-1"``) runs at
    ``severity`` of its current capacity for ``duration_s``."""

    t_s: float
    provider: str
    duration_s: float
    severity: float = 0.4


@dataclasses.dataclass(frozen=True)
class GrayLink:
    """Silent partial failure: the link delivers ``delivered_fraction`` of
    its believed throughput for ``duration_s`` with NO failure signal —
    compiled to ``GrayFailure`` events (down and silent recovery), which
    the TransferService deliberately never folds into its degraded view."""

    t_s: float
    src: int  # region index
    dst: int
    duration_s: float
    delivered_fraction: float = 0.3


@dataclasses.dataclass(frozen=True)
class FlappingLink:
    """The link cycles down/up ``n_flaps`` times: down to ``down_factor``
    at the start of each ``period_s`` window, restored after ``duty`` of
    the period. Each flap is a visible degrade/restore pair — exactly the
    failures-or-flaps signature a link circuit breaker counts."""

    t_s: float
    src: int  # region index
    dst: int
    n_flaps: int = 3
    period_s: float = 2.0
    down_factor: float = 0.05
    duty: float = 0.5


ARCHETYPES = (RegionOutage, ProviderBrownout, GrayLink, FlappingLink)


# --------------------------------------------------------------- compiler
def _links_touching(top, region: int) -> list[tuple[int, int]]:
    tput = np.asarray(top.tput)
    out = []
    for x in range(top.num_regions):
        if x == region:
            continue
        if tput[region, x] > 0:
            out.append((region, x))
        if tput[x, region] > 0:
            out.append((x, region))
    return out


def _provider_links(top, provider: str) -> list[tuple[int, int]]:
    tput = np.asarray(top.tput)
    keys = top.keys()
    mine = [i for i, k in enumerate(keys) if k.split(":")[0] == provider]
    mset = set(mine)
    return [
        (a, b)
        for a, b in np.argwhere(tput > 0).tolist()
        if a in mset or b in mset
    ]


def compile_archetypes(archetypes, top, n_jobs: int) -> list:
    """Materialize archetypes into the primitive events both sims execute.

    ``n_jobs`` scopes the VM kills of a RegionOutage (``VMFailure`` is
    per job — the outage hits every tenant's gateways in the region).
    Events come back sorted by time; the down/up pair of every window uses
    exactly inverse factors, so the capacity view compounds back to its
    pre-incident value once an incident lifts."""
    events: list = []
    for arch in archetypes:
        if isinstance(arch, RegionOutage):
            f = max(float(arch.severity), SEVERITY_FLOOR)
            for j in range(n_jobs):
                events.append(VMFailure(
                    t_s=arch.t_s, job=j, region=arch.region, count=_ALL_VMS,
                ))
            for a, b in _links_touching(top, arch.region):
                events.append(LinkDegrade(t_s=arch.t_s, src=a, dst=b, factor=f))
                events.append(LinkRestore(
                    t_s=arch.t_s + arch.duration_s, src=a, dst=b,
                    factor=1.0 / f,
                ))
        elif isinstance(arch, ProviderBrownout):
            f = max(float(arch.severity), SEVERITY_FLOOR)
            for a, b in _provider_links(top, arch.provider):
                events.append(LinkDegrade(t_s=arch.t_s, src=a, dst=b, factor=f))
                events.append(LinkRestore(
                    t_s=arch.t_s + arch.duration_s, src=a, dst=b,
                    factor=1.0 / f,
                ))
        elif isinstance(arch, GrayLink):
            f = min(max(float(arch.delivered_fraction), SEVERITY_FLOOR), 1.0)
            events.append(GrayFailure(
                t_s=arch.t_s, src=arch.src, dst=arch.dst, factor=f,
            ))
            events.append(GrayFailure(  # the recovery is just as silent
                t_s=arch.t_s + arch.duration_s, src=arch.src, dst=arch.dst,
                factor=1.0 / f,
            ))
        elif isinstance(arch, FlappingLink):
            f = max(float(arch.down_factor), SEVERITY_FLOOR)
            up = min(max(float(arch.duty), 0.05), 0.95) * arch.period_s
            for i in range(int(arch.n_flaps)):
                t0 = arch.t_s + i * arch.period_s
                events.append(LinkDegrade(
                    t_s=t0, src=arch.src, dst=arch.dst, factor=f,
                ))
                events.append(LinkRestore(
                    t_s=t0 + up, src=arch.src, dst=arch.dst, factor=1.0 / f,
                ))
        else:
            raise TypeError(f"unknown chaos archetype {arch!r}")
    events.sort(key=lambda e: e.t_s)
    return events


# ---------------------------------------------------------------- scenario
class ChaosScenario:
    """A seeded mix of correlated fault archetypes over ``horizon_s``.

    Every random draw happens once, here, from ``default_rng(seed)`` in a
    fixed order — after construction, ``archetypes`` is frozen data and
    ``events(n_jobs)`` is a pure compilation of it. ``links`` restricts
    link-scoped archetypes (gray / flapping) to the given directed pairs —
    point the chaos at the trunks a scenario's plans actually ride, or
    leave None to draw from every positive-throughput link.
    """

    def __init__(
        self,
        top,
        *,
        seed: int = 0,
        horizon_s: float = 30.0,
        n_region_outages: int = 0,
        n_brownouts: int = 0,
        n_gray: int = 1,
        n_flapping: int = 1,
        outage_duration_s: tuple[float, float] = (4.0, 10.0),
        outage_severity: float = SEVERITY_FLOOR,
        brownout_severity: tuple[float, float] = (0.3, 0.6),
        brownout_duration_s: tuple[float, float] = (5.0, 15.0),
        gray_fraction: tuple[float, float] = (0.15, 0.5),
        gray_duration_s: tuple[float, float] = (5.0, 15.0),
        flap_down_factor: float = 0.05,
        flap_period_s: tuple[float, float] = (1.0, 3.0),
        flap_count: tuple[int, int] = (2, 5),
        links: list[tuple[int, int]] | None = None,
    ):
        self.top = top
        self.seed = int(seed)
        self.horizon_s = float(horizon_s)
        rng = np.random.default_rng(self.seed)
        tput = np.asarray(top.tput)
        if links is None:
            links = [tuple(x) for x in np.argwhere(tput > 0).tolist()]
        if not links:
            raise ValueError("no candidate links for chaos")
        providers = sorted({k.split(":")[0] for k in top.keys()})

        arch: list = []
        for _ in range(int(n_region_outages)):
            arch.append(RegionOutage(
                t_s=float(rng.uniform(0.0, horizon_s)),
                region=int(rng.integers(top.num_regions)),
                duration_s=float(rng.uniform(*outage_duration_s)),
                severity=float(outage_severity),
            ))
        for _ in range(int(n_brownouts)):
            arch.append(ProviderBrownout(
                t_s=float(rng.uniform(0.0, horizon_s)),
                provider=providers[int(rng.integers(len(providers)))],
                duration_s=float(rng.uniform(*brownout_duration_s)),
                severity=float(rng.uniform(*brownout_severity)),
            ))
        for _ in range(int(n_gray)):
            a, b = links[int(rng.integers(len(links)))]
            arch.append(GrayLink(
                t_s=float(rng.uniform(0.0, horizon_s)),
                src=int(a), dst=int(b),
                duration_s=float(rng.uniform(*gray_duration_s)),
                delivered_fraction=float(rng.uniform(*gray_fraction)),
            ))
        for _ in range(int(n_flapping)):
            a, b = links[int(rng.integers(len(links)))]
            arch.append(FlappingLink(
                t_s=float(rng.uniform(0.0, horizon_s)),
                src=int(a), dst=int(b),
                n_flaps=int(rng.integers(flap_count[0], flap_count[1] + 1)),
                period_s=float(rng.uniform(*flap_period_s)),
                down_factor=float(flap_down_factor),
            ))
        arch.sort(key=lambda a: a.t_s)
        self.archetypes = arch

    def events(self, n_jobs: int) -> list:
        """The primitive event stream for an ``n_jobs``-job scenario."""
        return compile_archetypes(self.archetypes, self.top, n_jobs)
