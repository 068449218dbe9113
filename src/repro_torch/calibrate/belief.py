"""BeliefGrid: per-link throughput estimates with confidence.

The planner should never see the raw profile grid again — it sees a
*belief*: per ordered region pair, a weighted-mean throughput estimate
plus an effective observation count and variance. The belief starts at
the embedded profile grid with a weak prior (the stale measurement IS
evidence, just old evidence) and tightens as evidence arrives:

  * **active probes** (calibrate.Calibrator) — iperf-style measurements of
    a link's current capacity; high weight;
  * **passive telemetry** (flowsim / gateway per-link delivered rates) —
    free but allocation-shaped; low weight, fed through
    ``capacity_sample_from_rates`` which rescales an observed/expected
    ratio back into grid space.

Updates are weighted Welford: numerically stable streaming mean/variance
where a weight-w observation counts as w unit observations. The belief
exposes the two grids the planner consumes — the mean (``believed_
topology``) and the z-lower-confidence-bound scale vector (``scale_
grid``) that uncertainty-aware plans ride as cuts on cached LP structures.

The prior spread is per-link: by default it comes from the per-provider
drift table (``core.profiles.prior_rel_sigma_grid`` — AWS routes hold
steady, GCP routes jitter, inter-cloud peering drifts hardest), so an
intra-AWS link starts with a tighter confidence band than a GCP→Azure
link at the same grid value. Pass a scalar to restore one global knob,
or a [V, V] array for full control.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.profiles import prior_rel_sigma_grid
from repro_torch.core.topology import Topology

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class BeliefSnapshot:
    """An immutable, epoch-versioned read view of a ``BeliefGrid``.

    The fleet control plane shares ONE live belief across many tenant
    services; a tenant planning a cohort must not see the grid move under
    it mid-decision (another tenant's probe landing between its scale-cut
    computation and its admission would make the two inconsistent).
    ``BeliefGrid.snapshot()`` copies the sufficient statistics and stamps
    them with ``version`` (bumped on every fold/reset) and ``epoch`` —
    readers check ``grid.version != snap.version`` to know their view is
    stale, writers never block."""

    base: Topology
    mean: np.ndarray
    count: np.ndarray
    m2: np.ndarray
    min_tput: float
    version: int
    epoch: int
    taken_t: float | None = None

    def stderr(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            var = np.where(self.count > 0,
                           self.m2 / np.maximum(self.count, _EPS), 0.0)
        return np.sqrt(np.maximum(var, 0.0)) / np.sqrt(
            np.maximum(self.count, 1.0)
        )

    def lower_bound(self, z: float = 1.5) -> np.ndarray:
        lb = self.mean - float(z) * self.stderr()
        return np.where(self.mean > 0, np.maximum(lb, self.min_tput), 0.0)

    def scale_grid(
        self, epoch_top: Topology, z: float = 1.5, floor: float = 0.02
    ) -> np.ndarray:
        ref = np.asarray(epoch_top.tput, dtype=float)
        lb = self.lower_bound(z)
        with np.errstate(divide="ignore", invalid="ignore"):
            phi = np.where(ref > 0, lb / np.maximum(ref, _EPS), 1.0)
        return np.clip(phi, float(floor), 1.0)

    def believed_topology(self) -> Topology:
        return self.base.with_tput(self.mean)


class BeliefGrid:
    def __init__(
        self,
        base: Topology,
        *,
        prior_count: float = 4.0,
        prior_rel_sigma: float | np.ndarray | None = None,
        min_tput: float = 1e-3,
    ):
        self.base = base
        v = base.num_regions
        self.mean = np.array(base.tput, dtype=float, copy=True)
        mask = self.mean > 0
        self.count = np.where(mask, float(prior_count), 0.0)
        # per-link prior spread: provider-pair table by default, scalar or
        # explicit [V, V] override accepted
        if prior_rel_sigma is None:
            sig = prior_rel_sigma_grid(base)
        else:
            sig = np.asarray(prior_rel_sigma, dtype=float)
            if sig.ndim == 0:
                sig = np.full((v, v), float(sig))
            elif sig.shape != (v, v):
                raise ValueError(
                    f"prior_rel_sigma must be scalar or ({v}, {v}), "
                    f"got shape {sig.shape}"
                )
        self.prior_rel_sigma = sig
        # m2 = sum of weighted squared deviations: prior variance encodes
        # "the stale grid is probably within ~prior_rel_sigma of reality"
        self.m2 = np.where(
            mask, (sig * self.mean) ** 2 * prior_count, 0.0
        )
        self.min_tput = float(min_tput)
        self.observations = 0
        # concurrency story for shared (fleet) beliefs: version bumps on
        # every mutation, epoch on every planner re-anchoring (the
        # calibrated service's epoch roll) — snapshot() readers compare
        # both to detect staleness without ever blocking a writer
        self.version = 0
        self.epoch = 0
        # when each link was last measured: the stale profile counts as one
        # very old measurement, so probe targeting (staleness-aware scores)
        # sweeps every candidate before re-visiting
        self.last_obs_t = np.full((v, v), -np.inf)
        assert self.mean.shape == (v, v)

    # ---------------------------------------------------------------- updates
    def observe(
        self, src: int, dst: int, gbps: float, weight: float = 1.0,
        t_s: float | None = None,
    ):
        """Fold one throughput observation of link (src, dst) into the
        belief (weighted Welford; ``weight`` = equivalent unit samples)."""
        if src == dst:
            raise ValueError("no self-links")
        g = max(float(gbps), self.min_tput)
        w = float(weight)
        c1 = self.count[src, dst] + w
        delta = g - self.mean[src, dst]
        self.mean[src, dst] += w * delta / c1
        self.m2[src, dst] += w * delta * (g - self.mean[src, dst])
        self.count[src, dst] = c1
        if t_s is not None:
            self.last_obs_t[src, dst] = float(t_s)
        self.observations += 1
        self.version += 1

    def reset_link(
        self,
        src: int,
        dst: int,
        gbps: float,
        count: float = 4.0,
        rel_sigma: float | None = None,
        t_s: float | None = None,
    ):
        """Regime change on one link: discard its history and re-seed the
        belief at ``gbps``. A step-change incident draws from a NEW
        distribution — Welford-averaging it against the old regime would
        let the stale prior drag the mean for many rounds while the plan
        keeps trusting a collapsed link. The re-seeded spread defaults to
        the link's per-provider drift prior."""
        if src == dst:
            raise ValueError("no self-links")
        g = max(float(gbps), self.min_tput)
        rs = (
            float(self.prior_rel_sigma[src, dst])
            if rel_sigma is None
            else float(rel_sigma)
        )
        self.mean[src, dst] = g
        self.count[src, dst] = float(count)
        self.m2[src, dst] = (rs * g) ** 2 * float(count)
        if t_s is not None:
            self.last_obs_t[src, dst] = float(t_s)
        self.observations += 1
        self.version += 1

    def observe_adaptive(
        self,
        src: int,
        dst: int,
        gbps: float,
        weight: float = 1.0,
        z_reset: float = 3.0,
        t_s: float | None = None,
    ) -> bool:
        """Observe with change-point handling: a sample outside the
        z-confidence band (either direction) resets the link's belief to
        the new regime; an in-band sample folds in normally. Returns
        whether a reset happened."""
        g = max(float(gbps), self.min_tput)
        band = float(z_reset) * max(
            self.stderr()[src, dst], 0.02 * self.mean[src, dst]
        )
        if abs(g - self.mean[src, dst]) > band:
            self.reset_link(src, dst, g, count=max(float(weight), 1.0),
                            t_s=t_s)
            return True
        self.observe(src, dst, g, weight, t_s=t_s)
        return False

    def observe_link_rates(
        self,
        rates: dict,
        weight: float = 1.0,
        t_s: float | None = None,
        one_sided: bool = True,
    ) -> int:
        """Fold a {(src, dst): Gbps} mapping into the belief — the
        gateway-side passive feed (``GatewayReport.link_gbps()``), with
        the same change-point handling as simulator telemetry.

        Gateway windows span first-pickup to last-completion on each hop,
        so a hop throttled by an UPSTREAM bottleneck reads far below its
        own capacity. The default ``one_sided=True`` therefore treats a
        rate as a lower-bound observation: samples below the current mean
        are dropped (capacity >= observed is the only safe inference from
        a possibly-idle window); callers with saturation evidence (e.g. a
        single-hop path, or the sim feed's expectation-checked samples)
        pass ``one_sided=False``. Returns how many samples were folded."""
        n = 0
        for (a, b), g in rates.items():
            if a == b:
                continue
            if one_sided and float(g) < self.mean[a, b]:
                continue
            self.observe_adaptive(int(a), int(b), float(g),
                                  weight=weight, t_s=t_s)
            n += 1
        return n

    # ------------------------------------------------------------ uncertainty
    def sigma(self) -> np.ndarray:
        """Per-link sample standard deviation."""
        with np.errstate(divide="ignore", invalid="ignore"):
            var = np.where(self.count > 0, self.m2 / np.maximum(
                self.count, _EPS), 0.0)
        return np.sqrt(np.maximum(var, 0.0))

    def stderr(self) -> np.ndarray:
        """Standard error of the mean — shrinks with evidence."""
        return self.sigma() / np.sqrt(np.maximum(self.count, 1.0))

    def rel_uncertainty(self) -> np.ndarray:
        """stderr / mean — the probe-targeting signal (0 on dead links)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where(self.mean > 0, self.stderr() /
                         np.maximum(self.mean, _EPS), 0.0)
        return r

    def lower_bound(self, z: float = 1.5) -> np.ndarray:
        """mean - z * stderr, floored at ``min_tput`` on live links."""
        lb = self.mean - float(z) * self.stderr()
        return np.where(self.mean > 0, np.maximum(lb, self.min_tput), 0.0)

    def out_of_bounds(
        self, src: int, dst: int, observed_gbps: float, z: float = 3.0
    ) -> bool:
        """Drift detector primitive: is this capacity sample below the
        belief's z-confidence band on the link?"""
        band = float(z) * max(self.stderr()[src, dst],
                              0.02 * self.mean[src, dst])
        return float(observed_gbps) < self.mean[src, dst] - band

    # ------------------------------------------------------- planner-facing
    def snapshot(self, t_s: float | None = None) -> BeliefSnapshot:
        """Epoch-versioned immutable read view — what a fleet tenant plans
        against while other tenants keep folding probes into the live
        grid. Copies the sufficient statistics (O(V^2), cheap next to one
        LP solve); see ``BeliefSnapshot``."""
        return BeliefSnapshot(
            base=self.base,
            mean=self.mean.copy(),
            count=self.count.copy(),
            m2=self.m2.copy(),
            min_tput=self.min_tput,
            version=self.version,
            epoch=self.epoch,
            taken_t=t_s,
        )

    def roll_epoch(self) -> int:
        """Mark a planner re-anchoring (the calibrated service's epoch
        roll): bumps ``epoch`` so shared-belief readers can tell a mere
        mean drift from a re-based planning grid."""
        self.epoch += 1
        self.version += 1
        return self.epoch

    def believed_topology(self) -> Topology:
        """A fresh Topology carrying the belief mean — the planner's epoch
        grid (copy-on-write; caches start clean on the new instance)."""
        return self.base.with_tput(self.mean)

    def scale_grid(
        self, epoch_top: Topology, z: float = 1.5, floor: float = 0.02
    ) -> np.ndarray:
        """[V,V] per-link scale phi = lower_bound(z) / epoch grid, clipped
        to [floor, 1]. The planner turns phi < 1 entries into tightened 4b
        rows on its CACHED structures (milp.*.scale_cuts) — uncertainty-
        aware planning with zero re-assembly. phi is clipped at 1 because
        a loosening row never binds; a belief that *improved* past the
        epoch grid is exploited at the next epoch roll, not mid-epoch."""
        ref = np.asarray(epoch_top.tput, dtype=float)
        lb = self.lower_bound(z)
        with np.errstate(divide="ignore", invalid="ignore"):
            phi = np.where(ref > 0, lb / np.maximum(ref, _EPS), 1.0)
        return np.clip(phi, float(floor), 1.0)

    # ------------------------------------------------------------- diagnostics
    def error_vs(
        self, true_tput: np.ndarray, mask: np.ndarray | None = None
    ) -> float:
        """Mean relative belief error vs a true grid, over ``mask`` (default:
        every live link). The calibration loop's convergence metric."""
        true_tput = np.asarray(true_tput, dtype=float)
        m = (self.mean > 0) & (true_tput > 0)
        if mask is not None:
            m &= np.asarray(mask, dtype=bool)
        if not m.any():
            return 0.0
        rel = np.abs(self.mean[m] - true_tput[m]) / true_tput[m]
        return float(rel.mean())


def capacity_sample_from_rates(
    observed_gbps: float,
    expected_gbps: float,
    *,
    n_vms: float = 1.0,
    link_capacity_scale: float | None = 2.0,
    saturation_ratio: float = 0.9,
) -> float | None:
    """Convert a passive (observed, expected) link-rate pair into a grid-
    space capacity sample — or None when the telemetry carries no
    capacity information.

    Passive evidence is ONE-SIDED: a link that delivered what the plan
    asked (``observed >= saturation_ratio * expected``) only proves
    capacity >= observed — inferring "the grid entry is fine" from it
    would reset a freshly-learned degradation back to the stale prior.
    Only an UNDER-delivering link was capacity-bound, and then the grid
    entry (single-VM-pair rate) is the observed aggregate divided by the
    effective parallelism: ``min(n_vms, link_capacity_scale)`` — the VM
    fan-out the data plane multiplies the grid rate by, ceilinged by the
    shared-interconnect capacity factor."""
    if expected_gbps <= 1e-9:
        return None
    if observed_gbps >= saturation_ratio * expected_gbps:
        return None  # link kept up with the plan: no capacity info
    par = max(float(n_vms), 1.0)
    if link_capacity_scale is not None:
        par = min(par, float(link_capacity_scale))
    return float(max(observed_gbps, 1e-6) / par)
