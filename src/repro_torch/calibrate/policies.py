"""Probe-scheduling policies: *what to measure next* as a first-class
decision.

The Calibrator rations an explicit per-round budget ($, seconds, probe
count) across candidate links; a :class:`ProbePolicy` decides the ORDER
in which candidates bid for that budget. Four schedulers ship:

  * ``greedy``          — :class:`GreedyVoIPolicy`, the original heuristic
    (relative uncertainty + staleness, plan-flow bonus, sqrt-capacity
    weight). Cheap, myopic, the default.
  * ``round_robin``     — :class:`RoundRobinPolicy`, a least-recently-
    measured sweep. Ignores value entirely but *guarantees* staleness
    coverage: every candidate is eventually probed, so no link's belief
    can silently rot — the baseline any smarter policy must beat.
  * ``epsilon_greedy``  — :class:`EpsilonGreedyPolicy`, greedy with
    seed-deterministic random exploration: each rank slot defects to a
    uniformly random candidate with probability ``epsilon``.
  * ``evoi``            — :class:`BayesianEVOIPolicy`, Bayesian expected
    value of information: each candidate is priced by the *plan regret*
    its measurement could remove. The policy resolves the belief's
    z-lower-confidence-bound grid against its mean grid on the planner's
    CACHED LP structures (``Planner.max_throughput(tput_scale=...)`` —
    scale cuts ride the memoized ``milp.LPStructure``/
    ``MulticastLPStructure``, so ranking a round assembles NOTHING and
    ``milp.N_STRUCT_BUILDS`` stays pinned): the difference between the
    robust plan value with link *e* confirmed at its believed mean and
    the all-LCB robust plan value is the throughput the planner is
    leaving on the table *because* link *e* is uncertain. Probes go where
    that number is largest; when no probe can recover any plan value the
    policy degrades to greedy exploration.

Policies are stateless between processes but may carry state across
rounds (the ε-greedy RNG advances per call) — construct one per
experiment arm and reuse it for the arm's lifetime.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.spec import PlanSpec

from .belief import BeliefGrid


@dataclasses.dataclass(frozen=True)
class ProbeBudget:
    """Per-round spending caps: dollars, wall-clock, and probe count."""

    usd_per_round: float = 2.0
    seconds_per_round: float = 30.0
    max_probes_per_round: int = 8


@dataclasses.dataclass(frozen=True)
class PolicyContext:
    """Everything a policy may consult when ranking candidate links.

    ``planner``/``contexts``/``plans`` are optional — a policy must
    degrade gracefully when the round was launched from a bare link list
    (``Calibrator.run_round(links=...)``) with no planner attached."""

    belief: BeliefGrid
    t_s: float = 0.0
    budget: ProbeBudget | None = None
    planner: object | None = None
    contexts: tuple = ()  # (src, dst) or (src, [dsts]) planner keys
    plans: tuple = ()  # current TransferPlan / MulticastPlan objects
    # when each link was last ACTIVELY probed (grid, -inf = never). The
    # belief's own last_obs_t is refreshed by passive telemetry every
    # segment, so ranking staleness on it starves exactly the plan's
    # load-bearing links: allocation-shaped telemetry keeps them looking
    # fresh while proving nothing about capacity (it is one-sided — see
    # ``capacity_sample_from_rates``). Only a saturating probe re-earns
    # capacity confidence, so policies age links against this stamp when
    # the round's Calibrator provides it.
    last_probe_t: np.ndarray | None = None

    @property
    def probe_age_t(self) -> np.ndarray:
        """Per-link active-probe age stamps: ``last_probe_t`` when the
        Calibrator supplied them, else the belief's passive stamps."""
        if self.last_probe_t is not None:
            return self.last_probe_t
        return self.belief.last_obs_t


@runtime_checkable
class ProbePolicy(Protocol):
    """Ranks candidate links for one probe round.

    ``rank`` returns indices into ``links`` in descending priority; the
    Calibrator walks the ranking while the round's budget holds. The
    policy never spends the budget itself — separating *what is worth
    measuring* from *what we can afford* keeps budget enforcement in one
    place and identical across policies."""

    name: str

    def rank(
        self, links: list[tuple[int, int]], ctx: PolicyContext
    ) -> np.ndarray: ...


# --------------------------------------------------------------- greedy VoI
def greedy_voi_scores(
    links: list[tuple[int, int]],
    ctx: PolicyContext,
    *,
    on_plan_bonus: float = 2.0,
    staleness_halflife_s: float = 30.0,
) -> np.ndarray:
    """Value-of-information score per candidate link.

    score = (rel_uncertainty + staleness) * (1 + bonus * flow_share)
            * sqrt(mean):
    uncertain links first, a measurement's value decaying with its age
    (a link probed once is NOT trusted forever — links drift within
    hours, so confidence must be re-earned), plan-carrying links
    boosted by their share of the plan's flow, and everything weighted
    toward links with real capacity (a 0.1 Gbps alternate is worth
    less than a 5 Gbps trunk at equal uncertainty).

    The staleness term SATURATES at one halflife: past that the stamp is
    simply old, and what still separates candidates is uncertainty, plan
    relevance, and capacity — not how much older than stale each stamp
    is. Unbounded aging turns the score into a pure never-probed sweep
    (every unprobed zero-flow alternate outranks every probed link by
    orders of magnitude), which starves re-confirmation of the drifting
    flow-carrying trunks the plans actually depend on until the full
    candidate set has been swept once — tens of rounds on a real
    subgraph, far longer than links stay trustworthy."""
    belief = ctx.belief
    unc = belief.rel_uncertainty()
    mean = belief.mean
    flow = np.zeros_like(mean)
    for plan in ctx.plans:
        grid = getattr(plan, "G", None)
        if grid is None:
            grid = plan.F
        peak = float(np.max(grid, initial=0.0))
        if peak > 0:
            flow = np.maximum(flow, np.asarray(grid) / peak)
    age = np.clip(
        float(ctx.t_s) - ctx.probe_age_t, 0.0, None
    )  # inf for never-probed links (the stale prior is ancient)
    stale = np.where(np.isfinite(age), age / staleness_halflife_s, 1e9)
    out = np.empty(len(links))
    for i, (a, b) in enumerate(links):
        out[i] = (
            (unc[a, b] + 0.05 * min(stale[a, b], 1.0))
            * (1.0 + on_plan_bonus * flow[a, b])
            * np.sqrt(max(mean[a, b], 0.0))
        )
    return out


class GreedyVoIPolicy:
    """The original Calibrator heuristic, extracted: rank candidates by
    ``greedy_voi_scores`` and take them best-first. Myopic — it never
    asks whether a measurement would change any plan — but cheap and a
    strong default when uncertainty tracks plan relevance."""

    name = "greedy"

    def __init__(
        self,
        *,
        on_plan_bonus: float = 2.0,
        staleness_halflife_s: float = 30.0,
    ):
        self.on_plan_bonus = float(on_plan_bonus)
        self.staleness_halflife_s = float(staleness_halflife_s)

    def score(
        self, links: list[tuple[int, int]], ctx: PolicyContext
    ) -> np.ndarray:
        return greedy_voi_scores(
            links,
            ctx,
            on_plan_bonus=self.on_plan_bonus,
            staleness_halflife_s=self.staleness_halflife_s,
        )

    def rank(
        self, links: list[tuple[int, int]], ctx: PolicyContext
    ) -> np.ndarray:
        return np.argsort(-self.score(links, ctx), kind="stable")


# -------------------------------------------------------------- round robin
class RoundRobinPolicy:
    """Least-recently-measured sweep.

    Ranking is by the last-active-probe stamp (never-probed links,
    stamped ``-inf``, lead), ties broken by stable candidate order.
    Probing a link moves its stamp to *now* and sends it to the back of
    the queue, so successive rounds cycle through the full candidate
    set — a round-robin over a stable set, and a guarantee no
    score-driven policy gives: every candidate's staleness is bounded by
    (candidate count / probes per round) rounds."""

    name = "round_robin"

    def rank(
        self, links: list[tuple[int, int]], ctx: PolicyContext
    ) -> np.ndarray:
        last = ctx.probe_age_t
        stamps = np.array([last[a, b] for a, b in links])
        return np.lexsort((np.arange(len(links)), stamps))


# ------------------------------------------------------------ epsilon-greedy
class EpsilonGreedyPolicy:
    """Greedy VoI with seed-deterministic random exploration.

    Each rank slot defects to a uniformly random remaining candidate
    with probability ``epsilon`` (otherwise it takes the best remaining
    by greedy score). The RNG is owned by the policy and advances one
    draw per slot, so two policies built with the same seed and fed the
    same rounds produce bitwise-identical probe schedules."""

    name = "epsilon_greedy"

    def __init__(
        self,
        *,
        epsilon: float = 0.2,
        seed: int = 0,
        on_plan_bonus: float = 2.0,
        staleness_halflife_s: float = 30.0,
    ):
        if not 0.0 <= epsilon <= 1.0:
            raise ValueError(f"epsilon must be in [0, 1], got {epsilon}")
        self.epsilon = float(epsilon)
        self._rng = np.random.default_rng(seed)
        self._greedy = GreedyVoIPolicy(
            on_plan_bonus=on_plan_bonus,
            staleness_halflife_s=staleness_halflife_s,
        )

    def rank(
        self, links: list[tuple[int, int]], ctx: PolicyContext
    ) -> np.ndarray:
        base = list(np.argsort(-self._greedy.score(links, ctx), kind="stable"))
        order = []
        while base:
            if len(base) > 1 and self._rng.random() < self.epsilon:
                j = int(self._rng.integers(len(base)))
            else:
                j = 0
            order.append(base.pop(j))
        return np.asarray(order, dtype=np.int64)


# ------------------------------------------------------------- Bayesian EVOI
class BayesianEVOIPolicy:
    """Expected value of information, priced in plan throughput regret.

    The robust planner plans against the belief's z-lower-confidence-
    bound grid, so every uncertain link taxes the plan by the gap
    between its LCB and its mean. A probe that confirms link *e* at its
    believed mean removes exactly that link's tax; its expected value is

        EVOI(e) = V(phi_lcb with e at phi_mean) - V(phi_lcb)

    where V(phi) is the robust plan value (max achievable throughput,
    summed over the active transfer contexts) under full-grid scale
    ``phi``. V is evaluated AT THE PLAN'S PROVISIONED VM ALLOCATION
    (``vm_caps`` from each context's plan N vector, when plans are
    supplied): at full fleet scale the paper-grid max-flow is VM-bound
    and no link's uncertainty moves it, but the VMs a plan actually
    bought are where a drifted link genuinely costs throughput — regret
    is priced against the deployment we have, not a hypothetical
    re-provisioned one. Both V evaluations ride the planner's CACHED LP
    structures (``max_throughput`` / ``max_multicast_throughput`` with
    ``tput_scale=`` — scale cuts as extra rows, zero re-assembly,
    ``milp.N_STRUCT_BUILDS`` pinned after warm-up).

    The belief tracks a DRIFTING quantity, so the policy's uncertainty is
    not the belief's raw standard error: a link measured 30 seconds ago
    is less certain than the sample count suggests. The effective sigma
    grows with measurement age (``stale_sigma_rate`` of the mean per
    ``staleness_halflife_s``, capped at ``stale_sigma_cap`` — a random-
    walk drift prior on top of the Welford estimate), which re-opens the
    LCB/mean gap on confirmed links over time. That is what sends EVOI
    *back* to the plan's bottleneck links between incidents — without it
    a confirmed link would never be re-probed and a later collapse would
    go unseen.

    Only links whose LCB/mean gap exceeds ``gap_tol`` can have positive
    EVOI; at most ``eval_top_k`` of those are evaluated exactly (one LP
    each, plus one base solve) — plan-flow links first, then the largest
    gap-weighted greedy pre-scores — and everything else inherits EVOI 0.
    Ranking is EVOI-first with the greedy score as tiebreak, so once no
    probe can recover plan value (all regret resolved) the policy
    degrades to plain uncertainty-driven exploration instead of going
    blind."""

    name = "evoi"

    def __init__(
        self,
        *,
        z: float = 1.5,
        eval_top_k: int = 8,
        gap_tol: float = 1e-3,
        stale_sigma_rate: float = 0.08,
        stale_sigma_cap: float = 0.5,
        on_plan_bonus: float = 2.0,
        staleness_halflife_s: float = 30.0,
    ):
        self.z = float(z)
        self.eval_top_k = int(eval_top_k)
        self.gap_tol = float(gap_tol)
        self.stale_sigma_rate = float(stale_sigma_rate)
        self.stale_sigma_cap = float(stale_sigma_cap)
        self.staleness_halflife_s = float(staleness_halflife_s)
        self._greedy = GreedyVoIPolicy(
            on_plan_bonus=on_plan_bonus,
            staleness_halflife_s=staleness_halflife_s,
        )

    def _phi_eff(
        self, belief: BeliefGrid, top, t_s: float,
        probe_age_t: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(phi_lcb_eff, phi_mean): the scale grids the EVOI resolves.

        phi_lcb_eff is the belief's z-LCB scale with the drift prior
        folded in — sigma inflated by time since the last ACTIVE probe
        (passive telemetry cannot re-earn capacity confidence) — so the
        regret a stale link causes grows until a probe re-confirms it."""
        phi_mean = belief.scale_grid(top, z=0.0)
        stamps = probe_age_t if probe_age_t is not None else belief.last_obs_t
        age = np.clip(float(t_s) - stamps, 0.0, None)
        with np.errstate(invalid="ignore"):
            growth = np.where(
                np.isfinite(age),
                age / self.staleness_halflife_s * self.stale_sigma_rate,
                self.stale_sigma_cap,
            )
        sigma_eff = belief.stderr() + np.minimum(
            growth, self.stale_sigma_cap
        ) * belief.mean
        lb = np.where(
            belief.mean > 0,
            np.maximum(belief.mean - self.z * sigma_eff, belief.min_tput),
            0.0,
        )
        ref = np.asarray(top.tput, dtype=float)
        with np.errstate(divide="ignore", invalid="ignore"):
            phi = np.where(ref > 0, lb / np.maximum(ref, 1e-12), 1.0)
        return np.clip(phi, 0.02, 1.0), phi_mean

    @staticmethod
    def _vm_caps(plan) -> dict[int, float] | None:
        """The plan's provisioned VM allocation as a vm_caps dict (full-
        topology indices; regions the plan did not provision are capped
        at 0 — re-routing through them would need VMs nobody bought)."""
        n = getattr(plan, "N", None)
        if n is None:
            return None
        return {
            int(r): float(np.ceil(v)) for r, v in enumerate(np.asarray(n))
        }

    def _value(self, planner, contexts, plans, phi: np.ndarray) -> float:
        """Robust plan value under full-grid scale ``phi``: achievable
        throughput summed over contexts at their plans' VM allocations
        (plans pair with contexts positionally when the counts match),
        on cached structures."""
        paired = (
            plans if len(plans) == len(contexts)
            else (None,) * len(contexts)
        )
        total = 0.0
        for (src, dst), plan in zip(contexts, paired):
            caps = self._vm_caps(plan) if plan is not None else None
            if isinstance(dst, (list, tuple)):
                total += planner.plan(PlanSpec(
                    objective="max_throughput", src=src, dsts=tuple(dst),
                    vm_caps=caps, tput_scale=phi,
                ))
            else:
                total += planner.plan(PlanSpec(
                    objective="max_throughput", src=src, dst=dst,
                    vm_caps=caps, tput_scale=phi,
                ))
        return total

    def rank(
        self, links: list[tuple[int, int]], ctx: PolicyContext
    ) -> np.ndarray:
        pre = self._greedy.score(links, ctx)
        planner = ctx.planner
        if planner is None or not ctx.contexts:
            return np.argsort(-pre, kind="stable")
        belief = ctx.belief
        top = planner.top
        phi_lcb, phi_mean = self._phi_eff(
            belief, top, ctx.t_s, probe_age_t=ctx.last_probe_t
        )
        gaps = np.array([phi_mean[a, b] - phi_lcb[a, b] for a, b in links])
        # links carrying plan flow take the FRONT of the eval budget (they
        # are where regret lives, even right after a confirming probe
        # shrank their gap — gap-weighted selection alone would drop them
        # and degenerate to greedy between staleness cycles); whatever
        # budget remains goes to the largest gap-weighted pre-scores.
        # Total exact evaluations stay <= eval_top_k (+1 base solve).
        on_plan: set[int] = set()
        for plan in ctx.plans:
            grid = getattr(plan, "G", None)
            if grid is None:
                grid = plan.F
            g = np.asarray(grid)
            for i, (a, b) in enumerate(links):
                if g[a, b] > 1e-9:
                    on_plan.add(i)
        k = max(self.eval_top_k, 0)
        ordered = [
            int(i)
            for i in np.argsort(-(gaps * pre), kind="stable")
            if gaps[i] > self.gap_tol
        ]
        cand = (
            [i for i in ordered if i in on_plan]
            + [i for i in ordered if i not in on_plan]
        )[:k]
        evoi = np.zeros(len(links))
        if cand:
            base = self._value(planner, ctx.contexts, ctx.plans, phi_lcb)
            # IPM solves carry O(1e-9) numerical noise; a "gain" below the
            # tolerance is not signal and must not outrank the greedy
            # tiebreak
            tol = max(1e-6, 1e-7 * abs(base))
            for i in cand:
                a, b = links[i]
                phi = phi_lcb.copy()
                phi[a, b] = phi_mean[a, b]
                gain = self._value(
                    planner, ctx.contexts, ctx.plans, phi
                ) - base
                evoi[i] = gain if gain > tol else 0.0
        # EVOI is primary; the greedy pre-score orders the zero-regret tail
        # (and breaks exact EVOI ties deterministically)
        return np.lexsort((-pre, -evoi))


# ------------------------------------------------------------------ factory
POLICY_NAMES = ("greedy", "round_robin", "epsilon_greedy", "evoi")


def make_policy(spec: str, *, seed: int = 0, **kw) -> ProbePolicy:
    """Build a policy from its CLI name (``--policy`` flag, bench arms).

    ``seed`` only matters for stochastic policies (ε-greedy); extra
    keyword arguments go to the policy constructor. The shared scoring
    knobs (``on_plan_bonus``, ``staleness_halflife_s``) are accepted for
    every policy and dropped for the ones that do not score (so a
    Calibrator can thread its knobs through any spec)."""
    name = str(spec).replace("-", "_").lower()
    if name in ("round_robin", "rr"):
        for knob in ("on_plan_bonus", "staleness_halflife_s"):
            kw.pop(knob, None)
        return RoundRobinPolicy(**kw)
    if name in ("greedy", "voi"):
        return GreedyVoIPolicy(**kw)
    if name in ("epsilon_greedy", "eps_greedy"):
        return EpsilonGreedyPolicy(seed=seed, **kw)
    if name in ("evoi", "bayes", "bayesian", "bayesian_evoi"):
        return BayesianEVOIPolicy(**kw)
    raise ValueError(
        f"unknown probe policy {spec!r} (expected one of {POLICY_NAMES})"
    )
