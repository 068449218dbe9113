"""Calibration plane: online bandwidth probing, belief topology, and
uncertainty-aware re-planning (a copy of the reference package's
``calibrate/``; the service runs each segment on its own ``engine`` and
``device``).

The subsystem separates the TRUE topology (what the data plane delivers —
``drift.DriftModel``) from the BELIEVED topology (what the planner sees —
``belief.BeliefGrid``), spends an explicit probe budget according to a
pluggable scheduling policy (``policies``: greedy VoI, round-robin,
ε-greedy, Bayesian EVOI; executed by ``calibrator.Calibrator``), and
closes the measure→believe→plan→observe loop around the transfer service
(``service.CalibratedTransferService`` — including epoch rolls that
re-pin the planner's grid when the belief rises past it)."""

from .belief import (  # noqa: F401
    BeliefGrid,
    BeliefSnapshot,
    capacity_sample_from_rates,
)
from .calibrator import (  # noqa: F401
    Calibrator,
    ProbeBudget,
    ProbeRecord,
    ProbeRound,
)
from .drift import DriftModel, Incident  # noqa: F401
from .policies import (  # noqa: F401
    POLICY_NAMES,
    BayesianEVOIPolicy,
    EpsilonGreedyPolicy,
    GreedyVoIPolicy,
    PolicyContext,
    ProbePolicy,
    RoundRobinPolicy,
    make_policy,
)
from .service import (  # noqa: F401
    CalibratedServiceReport,
    CalibratedTransferService,
    DriftEvent,
    EpochRoll,
)

__all__ = [
    "POLICY_NAMES",
    "BayesianEVOIPolicy",
    "BeliefGrid",
    "BeliefSnapshot",
    "CalibratedServiceReport",
    "CalibratedTransferService",
    "Calibrator",
    "DriftEvent",
    "DriftModel",
    "EpochRoll",
    "EpsilonGreedyPolicy",
    "GreedyVoIPolicy",
    "Incident",
    "PolicyContext",
    "ProbeBudget",
    "ProbePolicy",
    "ProbeRecord",
    "ProbeRound",
    "RoundRobinPolicy",
    "capacity_sample_from_rates",
    "make_policy",
]
