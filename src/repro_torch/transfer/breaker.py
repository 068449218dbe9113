"""Link circuit breaker: quarantine flaky links instead of retrying them.

A link that fails or flaps repeatedly inside a short window is not worth
re-planning onto — every re-plan that trusts its restored capacity walks
the next transfer into the next flap. The breaker gives the service a
three-state policy per directed link:

  * **closed**    — healthy; failures are counted in a sliding window;
  * **open**      — ``k`` failures-or-flaps landed within ``window_s``:
    the link is quarantined (the service pins its degraded-view factor to
    0.0, which the planner turns into ``extra_ub = 0`` rows on the CACHED
    LP structures — zero re-assembly) and no plan may use it;
  * **half-open** — ``cooldown_s`` after opening, one probe is allowed
    through: healthy (``>= heal_ratio`` of the epoch grid) closes the
    breaker and lifts the quarantine, unhealthy re-opens it for another
    cooldown.

The breaker itself is pure bookkeeping — it never touches a plan or a
belief. The TransferService owns the quarantine view; the calibrated
service additionally routes the half-open probe through its Calibrator
and feeds the measurement to ``BeliefGrid.reset_link`` so the belief
treats quarantine entry/exit as a regime change, not more noise.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import get_tracer

Link = tuple[int, int]

_trips = REGISTRY.counter("breaker.trips")


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    k: int = 3  # failures-or-flaps within window_s that open the breaker
    window_s: float = 30.0
    cooldown_s: float = 20.0  # open -> half-open delay
    heal_ratio: float = 0.5  # half-open probe must measure this fraction
    # of the epoch-grid rate for the breaker to close


@dataclasses.dataclass
class _LinkState:
    failures: deque = dataclasses.field(default_factory=deque)  # times
    state: str = "closed"  # "closed" | "open" | "half_open"
    opened_at: float = 0.0
    restore_seen: bool = False  # a LinkRestore arrived since opening
    trips: int = 0


@dataclasses.dataclass(frozen=True)
class BreakerTransition:
    """One audit-trail entry: the breaker changed state on a link."""

    t_s: float
    link: Link
    state: str  # the state entered: "open" | "half_open" | "closed"
    failures_in_window: int = 0


class LinkBreaker:
    """Per-link failure counting and open/half-open/closed transitions.

    All methods take the scenario clock ``t_s`` explicitly — the breaker
    holds no wall-clock state, so simulated services drive it with
    simulated time and tests are deterministic.
    """

    def __init__(self, config: BreakerConfig | None = None, **kw):
        self.config = config if config is not None else BreakerConfig(**kw)
        if self.config.k < 1:
            raise ValueError("breaker needs k >= 1")
        self._links: dict[Link, _LinkState] = {}
        self.transitions: list[BreakerTransition] = []

    def _state(self, link: Link) -> _LinkState:
        return self._links.setdefault(link, _LinkState())

    # ------------------------------------------------------------- signals
    def record_failure(self, link: Link, t_s: float) -> bool:
        """Count one failure-or-flap on ``link`` at ``t_s``. Returns True
        when this failure just OPENED the breaker (the caller quarantines
        the link); failures on an already-open link only refresh the
        window."""
        st = self._state(link)
        st.failures.append(float(t_s))
        lo = float(t_s) - self.config.window_s
        while st.failures and st.failures[0] < lo:
            st.failures.popleft()
        if st.state != "closed":
            return False
        if len(st.failures) >= self.config.k:
            st.state = "open"
            st.opened_at = float(t_s)
            st.restore_seen = False
            st.trips += 1
            _trips.inc()
            self.transitions.append(BreakerTransition(
                t_s=float(t_s), link=link, state="open",
                failures_in_window=len(st.failures),
            ))
            tr = get_tracer()
            if tr.enabled:
                tr.instant("breaker.open", float(t_s), track="breaker",
                           link=f"{link[0]}->{link[1]}",
                           failures=len(st.failures))
            return True
        return False

    def note_restore(self, link: Link, t_s: float) -> None:
        """A visible LinkRestore arrived — on an open link this is the
        base service's stand-in health signal for the half-open check
        (the calibrated service probes instead)."""
        st = self._links.get(link)
        if st is not None and st.state in ("open", "half_open"):
            st.restore_seen = True

    # -------------------------------------------------------- transitions
    def is_quarantined(self, link: Link) -> bool:
        """True while no plan may use the link (open OR half-open: the
        probe goes through, tenant traffic does not)."""
        st = self._links.get(link)
        return st is not None and st.state != "closed"

    def due_half_open(self, t_s: float) -> list[Link]:
        """Open links whose cooldown has elapsed — each transitions to
        half-open and is returned for the caller to probe."""
        due = []
        for link, st in sorted(self._links.items()):
            if (
                st.state == "open"
                and float(t_s) >= st.opened_at + self.config.cooldown_s
            ):
                st.state = "half_open"
                self.transitions.append(BreakerTransition(
                    t_s=float(t_s), link=link, state="half_open",
                ))
                tr = get_tracer()
                if tr.enabled:
                    tr.instant("breaker.half_open", float(t_s),
                               track="breaker",
                               link=f"{link[0]}->{link[1]}")
                due.append(link)
        return due

    def half_open_result(self, link: Link, t_s: float, healthy: bool) -> None:
        """Resolve a half-open probe: close (and forget the failure
        history — the next regime starts clean) or re-open for another
        cooldown."""
        st = self._state(link)
        if healthy:
            st.state = "closed"
            st.failures.clear()
            st.restore_seen = False
            self.transitions.append(BreakerTransition(
                t_s=float(t_s), link=link, state="closed",
            ))
        else:
            st.state = "open"
            st.opened_at = float(t_s)
            st.restore_seen = False
            self.transitions.append(BreakerTransition(
                t_s=float(t_s), link=link, state="open",
            ))
        tr = get_tracer()
        if tr.enabled:
            tr.instant("breaker.close" if healthy else "breaker.reopen",
                       float(t_s), track="breaker",
                       link=f"{link[0]}->{link[1]}")

    def restore_seen(self, link: Link) -> bool:
        st = self._links.get(link)
        return st is not None and st.restore_seen

    # ----------------------------------------------------------- reporting
    def open_links(self) -> list[Link]:
        return sorted(
            link for link, st in self._links.items() if st.state != "closed"
        )

    @property
    def trips(self) -> int:
        return sum(st.trips for st in self._links.values())
