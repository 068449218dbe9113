"""transfer.sim — the port's multi-job simulation entry point.

``simulate`` has the reference dispatcher's signature (the ``SimConfig``
knobs, or a ``config``, plus ``engine``) and one more argument,
``device``. The port registers one engine, ``"torch"``: the fixed-shape
device-resident loop of ``flowsim_torch``, chunk for chunk identical to
the reference package's engines. ``device`` None runs it on the card; the
tests pass ``device="cpu"``.
"""

from __future__ import annotations

from .simconfig import ENGINE_NAMES, SimConfig
from .simconfig import resolve as resolve_sim_config

__all__ = ["simulate"]


def simulate(
    jobs,
    faults=(),
    *,
    config: SimConfig | None = None,
    link_capacity_scale: float | None = 2.0,
    straggler_prob: float = 0.05,
    straggler_speed: tuple[float, float] = (0.15, 0.5),
    relay_buffer_chunks: int = 64,
    seed: int = 0,
    horizon_s: float | None = None,
    exec_top=None,
    drain: bool = False,
    engine: str = "torch",
    device=None,
):
    """Run a multi-job transfer scenario on the selected engine.

    Accepts either a :class:`SimConfig` (``config=...``, which carries
    ``engine`` too) or the individual kwargs — passing a knob both ways
    raises. Returns ``events.MultiSimResult``."""
    cfg = resolve_sim_config(
        config, link_capacity_scale=link_capacity_scale,
        straggler_prob=straggler_prob, straggler_speed=straggler_speed,
        relay_buffer_chunks=relay_buffer_chunks, seed=seed,
        horizon_s=horizon_s, exec_top=exec_top, drain=drain, engine=engine,
    )
    if cfg.engine == "torch":
        from .flowsim_torch import simulate_multi_torch

        return simulate_multi_torch(jobs, faults, config=cfg, device=device)
    names = ", ".join(ENGINE_NAMES)
    raise ValueError(  # unreachable: SimConfig validates eagerly
        f"unknown sim engine {cfg.engine!r}; registered engines: {names}"
    )
