"""SimConfig — the one simulation-surface shape the port's sim consumes.

A copy of the reference package's ``transfer/simconfig.py``: the same
knobs with the same defaults, so a scenario configured for the reference
engines configures the port's engine unchanged. Passing a knob both in
``SimConfig`` and as a keyword argument is an error (no silent precedence
rules).

This module is import-leaf (stdlib only) so the engine and ``events.py``
can use it without circularity. The registered engine NAMES live here for
the same reason: ``transfer.sim`` (the dispatcher) accepts exactly
``ENGINE_NAMES``, while ``SimConfig`` can validate eagerly without
importing any engine.
"""

from __future__ import annotations

import dataclasses

# The port's simulation engines:
#   "torch" — fixed-shape device-resident loop (flowsim_torch)
ENGINE_NAMES = ("torch",)


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
    # dispatcher) reads it
    engine: str = "torch"

    def __post_init__(self):
        if self.engine not in ENGINE_NAMES:
            names = ", ".join(ENGINE_NAMES)
            raise ValueError(
                f"unknown sim engine {self.engine!r}; registered engines: "
                f"{names}"
            )

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


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
