"""Calibrator: spend a probe budget where planner value-of-information is
highest.

An active probe is an iperf-style transfer of ``probe_gb`` over one
directed region pair — it costs real money (egress on the probed link
plus VM-seconds at both ends) and real time, so the paper's
"$4000 of iperf3" cannot simply be re-run every hour. The Calibrator
rations an explicit per-round budget (dollars AND seconds) across the
links the planner actually cares about:

  * candidate links are the edges of the planner's pruned candidate
    subgraphs for the active (src, dst[s]) contexts — the only links a
    plan could ever use;
  * each candidate is scored ``relative belief uncertainty x plan
    relevance``: links carrying flow in a current plan (on or near the
    Pareto frontier the planner picked from) outrank idle alternates,
    scaled by how much capacity the link could contribute;
  * probes are batched per round (they run concurrently, like the paper's
    parallel iperf grid): the round's wall time is the slowest probe, the
    round's cost is the sum.

Measurements sample the TRUE grid (a ``DriftModel`` lookup at the round's
time) with optional seeded measurement noise, and fold into the belief at
``probe_weight`` — several equivalent unit observations, since an active
probe saturates the link rather than inferring from allocation-shaped
telemetry.

WHICH candidates bid for the budget first is a pluggable
:mod:`~repro_torch.calibrate.policies` decision (greedy VoI, round-robin,
ε-greedy, Bayesian EVOI); the Calibrator owns budget enforcement and
measurement execution, identical across policies.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import GBIT_PER_GB
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import get_tracer

from .belief import BeliefGrid
from .policies import (
    GreedyVoIPolicy,
    PolicyContext,
    ProbeBudget,
    ProbePolicy,
    make_policy,
)

__all__ = ["Calibrator", "ProbeBudget", "ProbeRecord", "ProbeRound"]


@dataclasses.dataclass(frozen=True)
class ProbeRecord:
    t_s: float
    src: int
    dst: int
    measured_gbps: float
    cost_usd: float
    duration_s: float


@dataclasses.dataclass
class ProbeRound:
    t_s: float
    records: list[ProbeRecord]
    cost_usd: float
    duration_s: float  # probes run concurrently: the slowest one
    belief_error: float | None = None  # vs-true error AFTER the round
    policy: str = ""  # scheduling policy that ranked this round
    deduped: int = 0  # candidates skipped as freshly measured (fleet
    # cross-tenant amortization: another tenant's probe already landed
    # inside the dedup window)

    @property
    def n_probes(self) -> int:
        return len(self.records)


class Calibrator:
    def __init__(
        self,
        belief: BeliefGrid,
        *,
        budget: ProbeBudget | None = None,
        probe_gb: float = 0.5,
        probe_weight: float = 4.0,
        noise_sigma: float = 0.0,
        on_plan_bonus: float = 2.0,
        staleness_halflife_s: float = 30.0,
        seed: int = 0,
        policy: ProbePolicy | str | None = None,
        dedup_window_s: float = 0.0,
    ):
        self.belief = belief
        self.budget = budget or ProbeBudget()
        self.probe_gb = float(probe_gb)
        self.probe_weight = float(probe_weight)
        self.noise_sigma = float(noise_sigma)
        self.on_plan_bonus = float(on_plan_bonus)
        self.staleness_halflife_s = float(staleness_halflife_s)
        # cross-tenant probe dedup (the fleet's shared profiler): a
        # candidate whose belief entry was measured within the window —
        # by ANY tenant sharing this calibrator — is skipped this round,
        # amortizing probe $ across the fleet. 0 disables (per-service
        # calibrators keep the historical behavior, including same-
        # timestamp targeted rounds).
        self.dedup_window_s = float(dedup_window_s)
        # when each link was last ACTIVELY probed (passive telemetry does
        # not count: a throttled link looks freshly-observed every segment,
        # and deduping — or staleness-ranking — against that would skip
        # exactly the saturating probe that could expose the drift). Kept
        # both as a dict (dedup lookups) and as a grid handed to policies
        # so their staleness terms age links by probe time, not by the
        # last allocation-shaped telemetry sample.
        self.last_probe_t: dict[tuple[int, int], float] = {}
        self._probe_t_grid = np.full_like(
            np.asarray(belief.mean, dtype=float), -np.inf
        )
        self._rng = np.random.default_rng(seed)
        # the greedy scorer stays available (score_links) even when another
        # policy schedules the rounds — diagnostics and ε-greedy reuse it
        self._greedy = GreedyVoIPolicy(
            on_plan_bonus=self.on_plan_bonus,
            staleness_halflife_s=self.staleness_halflife_s,
        )
        if policy is None:
            self.policy: ProbePolicy = self._greedy
        elif isinstance(policy, str):
            # string specs inherit this Calibrator's scoring knobs, so
            # policy="greedy" is the default policy, not a differently
            # tuned one
            self.policy = make_policy(
                policy, seed=seed,
                on_plan_bonus=self.on_plan_bonus,
                staleness_halflife_s=self.staleness_halflife_s,
            )
        else:
            self.policy = policy
        self.rounds: list[ProbeRound] = []

    # ------------------------------------------------------------- selection
    def candidate_links(self, planner, contexts) -> list[tuple[int, int]]:
        """Edges of the planner's pruned candidate subgraphs for the given
        contexts (``(src, dst)`` or ``(src, [dsts])`` key tuples), mapped to
        full-topology indices, deduplicated in first-seen order."""
        seen: set[tuple[int, int]] = set()
        out: list[tuple[int, int]] = []
        for ctx in contexts:
            src, dst = ctx
            if isinstance(dst, (list, tuple)):
                sub, s, ds, keep = planner._prune_mc(src, list(dst))
                edges = sub.edge_list(s, None)
            else:
                sub, s, t, keep = planner._prune(src, dst)
                edges = sub.edge_list(s, t)
            for a, b in edges:
                e = (keep[a], keep[b])
                if e not in seen:
                    seen.add(e)
                    out.append(e)
        return out

    def score_links(self, links, plans=(), t_s: float = 0.0) -> np.ndarray:
        """Greedy value-of-information score per candidate link — the
        default policy's scorer (see ``policies.greedy_voi_scores``),
        kept as a method for diagnostics regardless of which policy is
        scheduling the rounds."""
        ctx = PolicyContext(
            belief=self.belief, t_s=float(t_s), budget=self.budget,
            plans=tuple(plans), last_probe_t=self._probe_t_grid,
        )
        return self._greedy.score(list(links), ctx)

    # -------------------------------------------------------------- execution
    def run_round(
        self,
        t_s: float,
        true_tput: np.ndarray,
        *,
        planner=None,
        contexts=(),
        plans=(),
        links: list[tuple[int, int]] | None = None,
    ) -> ProbeRound:
        """One batched probe round at time ``t_s`` against the true grid.

        Candidates come from ``links`` if given, else from the planner's
        pruned subgraphs for ``contexts``. The round's policy ranks the
        candidates; the Calibrator takes them in rank order while the
        round's dollar / second / count budget holds, then folds every
        measurement into the belief."""
        # dedup applies to the broad VoI sweeps only: an explicitly
        # targeted round (breaker half-open, drift confirmation) exists to
        # get a FRESH saturating measurement and always runs
        targeted = links is not None
        if links is None:
            if planner is None:
                raise ValueError("need either links= or planner+contexts")
            links = self.candidate_links(planner, contexts)
        true_tput = np.asarray(true_tput, dtype=float)
        ctx = PolicyContext(
            belief=self.belief, t_s=float(t_s), budget=self.budget,
            planner=planner, contexts=tuple(contexts), plans=tuple(plans),
            last_probe_t=self._probe_t_grid,
        )
        order = np.asarray(self.policy.rank(list(links), ctx), dtype=np.int64)

        base = self.belief.base
        records: list[ProbeRecord] = []
        spent_usd = 0.0
        longest = 0.0
        deduped = 0
        for i in order:
            if len(records) >= self.budget.max_probes_per_round:
                break
            a, b = links[int(i)]
            truth = float(true_tput[a, b])
            if truth <= 0:
                continue
            if (not targeted and self.dedup_window_s > 0.0
                    and self.last_probe_t.get((int(a), int(b)), -np.inf)
                    >= float(t_s) - self.dedup_window_s):
                deduped += 1
                continue
            measured = truth
            if self.noise_sigma > 0:
                measured *= float(np.exp(
                    self._rng.normal(0.0, self.noise_sigma)
                ))
            # a probe runs for min(full volume, round window): a collapsed
            # link — the highest-VoI candidate there is — still gets
            # measured, it just moves fewer bytes in the capped window
            # (iperf reports the observed rate either way)
            duration = min(
                self.probe_gb * GBIT_PER_GB / max(measured, 1e-6),
                self.budget.seconds_per_round,
            )
            gb_moved = measured * duration / GBIT_PER_GB
            cost = (
                gb_moved * float(base.price_egress[a, b])
                + duration * float(base.price_vm[a] + base.price_vm[b])
            )
            if spent_usd + cost > self.budget.usd_per_round:
                continue
            spent_usd += cost
            longest = max(longest, duration)
            records.append(ProbeRecord(
                t_s=float(t_s), src=int(a), dst=int(b),
                measured_gbps=measured, cost_usd=cost, duration_s=duration,
            ))
        for r in records:
            # probes saturate the link, so a measurement far outside the
            # belief's band is a regime change, not noise: change-point
            # handling resets the link instead of averaging against stale
            # history (observe_adaptive)
            self.belief.observe_adaptive(r.src, r.dst, r.measured_gbps,
                                         weight=self.probe_weight,
                                         t_s=float(t_s))
            self.last_probe_t[(r.src, r.dst)] = float(t_s)
            self._probe_t_grid[r.src, r.dst] = float(t_s)
        # convergence metric scoped to the links the calibrator can act on
        # (the candidate set): global grid error is dominated by links no
        # plan could ever use and no budget could ever probe
        mask = np.zeros_like(true_tput, dtype=bool)
        for a, b in links:
            mask[a, b] = True
        rnd = ProbeRound(
            t_s=float(t_s), records=records,
            cost_usd=spent_usd, duration_s=longest,
            belief_error=self.belief.error_vs(true_tput, mask=mask),
            policy=getattr(self.policy, "name", type(self.policy).__name__),
            deduped=deduped,
        )
        self.rounds.append(rnd)
        REGISTRY.counter("calibrate.probes").inc(len(records))
        REGISTRY.counter("calibrate.probe_usd").inc(spent_usd)
        REGISTRY.counter("calibrate.probe_s").inc(longest)
        if deduped:
            REGISTRY.counter("calibrate.dedup_hits").inc(deduped)
        tr = get_tracer()
        if tr.enabled:
            tr.instant("calibrate.probe_round", float(t_s),
                       track="calibrate", probes=len(records),
                       deduped=deduped, usd=round(spent_usd, 6),
                       targeted=targeted)
        return rnd

    # ------------------------------------------------------------ accounting
    @property
    def total_cost_usd(self) -> float:
        return sum(r.cost_usd for r in self.rounds)

    @property
    def total_probe_seconds(self) -> float:
        return sum(r.duration_s for r in self.rounds)

    @property
    def total_probes(self) -> int:
        return sum(r.n_probes for r in self.rounds)
