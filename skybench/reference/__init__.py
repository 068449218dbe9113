"""The benchmark's plain reference: a frozen copy of the numpy ``soa`` sim.

Copied from the JAX package's pure-numpy files at commit 9de379d4b486,
with only their imports changed so that they import one another here:

  * ``src/repro/transfer/flowsim.py`` -> ``transfer/flowsim.py``
    (``_simulate_multi_impl`` is the ``soa`` engine),
  * ``src/repro/transfer/events.py`` -> ``transfer/events.py``,
  * ``src/repro/transfer/simconfig.py`` -> ``transfer/simconfig.py``,
  * ``src/repro/core/topology.py`` -> ``core/topology.py``,
  * ``src/repro/core/plan.py`` -> ``core/plan.py``,
  * ``src/repro/core/profiles.py`` -> ``core/profiles.py`` (the embedded
    throughput and price grids),
  * ``src/repro/core/baselines.py`` -> ``core/baselines.py``
    (``direct_plan``),
  * ``src/repro/obs/trace.py`` -> ``obs/trace.py`` (the disabled tracer
    the sim asks for).

It imports numpy and the standard library only: neither ``jax``, nor the
JAX package, nor anything of the program under test. The benchmark builds
every cell's topology and plans with it, hands the same arrays to the
program, and holds each timed sim's result against this engine's.
"""
