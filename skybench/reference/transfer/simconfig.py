# Frozen copy of src/repro/transfer/simconfig.py at commit 9de379d4b486;
# only the imports changed.
"""SimConfig — the one simulation-surface shape both sims consume.

``flowsim.simulate_multi`` (vectorized) and
``flowsim_ref.simulate_multi_reference`` (oracle) historically mirrored
eight keyword arguments by hand; any drift between the two signatures
silently broke the chunk-for-chunk parity the oracle exists to pin.
``SimConfig`` names that surface once:

  * both sims accept ``config=SimConfig(...)`` carrying every knob;
  * the individual kwargs remain for backward compatibility, but passing a
    knob BOTH ways is an error (no silent precedence rules);
  * ``tests/test_api_surface.py`` introspects both signatures and the
    SimConfig field set, so the oracle can never drift from the fast path
    again.

This module is import-leaf (numpy only) so both sims and ``events.py``
can use it without circularity. The registered engine NAMES live here for
the same reason: ``transfer.sim`` (the dispatcher) asserts its registry
matches ``ENGINE_NAMES``, while ``SimConfig`` can validate eagerly without
importing any engine.
"""

from __future__ import annotations

import dataclasses
import warnings

# The sanctioned simulation engines, in oracle -> fast -> accelerator order:
#   "ref" — object-per-connection oracle (flowsim_ref)
#   "soa" — vectorized numpy event loop (flowsim)
#   "jax" — fixed-shape accelerator-resident loop (flowsim_jax)
ENGINE_NAMES = ("ref", "soa", "jax")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Every knob of the multi-job data-plane simulation.

    Field defaults ARE the legacy kwarg defaults — ``SimConfig()`` is the
    exact historical behavior of calling either sim with no kwargs."""

    # shared wide-area link capacity factor (None disables link contention)
    link_capacity_scale: float | None = 2.0
    straggler_prob: float = 0.05
    straggler_speed: tuple[float, float] = (0.15, 0.5)
    relay_buffer_chunks: int = 64
    seed: int = 0
    horizon_s: float | None = None  # cut the run (jobs report "running")
    exec_top: object | None = None  # execute on a different grid (TRUE vs
    # believed — the calibration plane's split)
    drain: bool = False  # graceful horizon: in-flight chunks complete
    # which event loop runs the scenario; only transfer.sim.simulate (the
    # dispatcher) reads it — the deprecated per-engine entry points ignore
    # it by design (each IS one engine)
    engine: str = "soa"

    def __post_init__(self):
        if self.engine not in ENGINE_NAMES:
            raise ValueError(
                f"unknown sim engine {self.engine!r}; registered engines: "
                f"{', '.join(ENGINE_NAMES)}"
            )

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def warn_deprecated_entry(name: str) -> None:
    """One deprecation message for the per-engine sim entry points."""
    warnings.warn(
        f"{name}() is deprecated; call transfer.sim.simulate(...) with "
        'SimConfig(engine=...) or engine="..." (see README "Sim engines")',
        DeprecationWarning,
        stacklevel=3,
    )


def resolve(config: SimConfig | None, **kwargs) -> SimConfig:
    """Merge a sim's legacy kwargs with an optional ``config``.

    With no config, the kwargs build one. With a config, every legacy
    kwarg must still sit at its default — passing a knob both ways is
    ambiguous and raises rather than picking a winner silently."""
    if config is None:
        return SimConfig(**kwargs)
    ref = SimConfig()
    for k, v in kwargs.items():
        dv = getattr(ref, k)
        if not (v is dv or v == dv):
            raise ValueError(
                f"simulation knob {k!r} was passed both in SimConfig and "
                "as a keyword argument; pick one"
            )
    return config
