"""The port's planner against the reference package's, on the Fig. 6 route.

``backend="torch"`` runs the round-down pipeline on the port's batched
torch IPM (here on the CPU). The reference's counterpart is its batched
jax IPM, selected with ``REPRO_BATCH_ENGINE=jax`` under the x64 shim
(module-scoped, removed on teardown). The two pick the same N and M. The
sequential numpy pipeline agrees on N, the throughput and the cost; its
M may sit elsewhere on the LP's optimal face (connections carry no cost),
so M is held against it only through ``validate()`` and the cost.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest

from repro.core import Planner as RefPlanner
from repro.core import PlanSpec as RefSpec
from repro.core import default_topology as ref_default
from repro.core import direct_plan as ref_direct
from repro.core import grid_fingerprint as ref_fingerprint
from repro.core import toy_topology as ref_toy
from repro_torch.core import Planner, PlanSpec, default_topology, milp
from repro_torch.core import grid_fingerprint, toy_topology
from repro_torch.obs.metrics import REGISTRY
from test_torch_cases import one_thread  # noqa: F401

SRC, DST = "aws:us-east-1", "aws:ap-southeast-2"
VOLUME = 640.0
_SHIMMED = ("repro.core.solver.ipm_jax", "repro.transfer.flowsim_jax")


@pytest.fixture(scope="module")
def plans():
    """Fig. 6 tput_max plans: the port (torch, numpy) and the reference
    (jax IPM engine, numpy)."""
    import jax
    import jax.experimental

    had = hasattr(jax.experimental, "enable_x64")
    if not had:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    mp = pytest.MonkeyPatch()
    try:
        rtop = ref_default()
        ceiling = ref_direct(rtop, SRC, DST, VOLUME).cost_per_gb * 1.15

        def ref_plan(backend):
            return RefPlanner(rtop).plan(RefSpec(
                objective="tput_max", src=SRC, dst=DST,
                cost_ceiling_per_gb=ceiling, volume_gb=VOLUME, n_samples=8,
                backend=backend,
            ))

        def port_plan(planner, backend):
            return planner.plan(PlanSpec(
                objective="tput_max", src=SRC, dst=DST,
                cost_ceiling_per_gb=ceiling, volume_gb=VOLUME, n_samples=8,
                backend=backend,
            ))

        mp.setenv("REPRO_BATCH_ENGINE", "jax")
        out = {"ref_jax": ref_plan("jax")}
        mp.delenv("REPRO_BATCH_ENGINE")
        out["ref_numpy"] = ref_plan("numpy")
        planner = Planner(default_topology(), device="cpu")
        out["torch"] = port_plan(planner, "torch")
        out["numpy"] = port_plan(Planner(default_topology()), "numpy")
        builds0 = milp._struct_builds.value
        out["replan"] = planner.plan(PlanSpec(
            objective="cost_min", src=SRC, dst=DST,
            tput_goal_gbps=out["torch"].tput_goal, volume_gb=VOLUME,
            backend="torch",
        ))
        out["replan_builds"] = milp._struct_builds.value - builds0
        yield out
    finally:
        mp.undo()
        if not had:
            del jax.experimental.enable_x64
            for name in _SHIMMED:
                sys.modules.pop(name, None)
                parent, _, child = name.rpartition(".")
                pkg = sys.modules.get(parent)
                if pkg is not None and child in vars(pkg):
                    delattr(pkg, child)


def test_torch_plan_matches_reference_jax_engine(plans):
    got, want = plans["torch"], plans["ref_jax"]
    assert got.tput_goal == pytest.approx(want.tput_goal)
    assert got.cost_per_gb == pytest.approx(want.cost_per_gb, abs=1e-6)
    np.testing.assert_array_equal(got.N, want.N)
    np.testing.assert_array_equal(got.M, want.M)
    assert got.validate() == [] and want.validate() == []


@pytest.mark.parametrize("other", ["ref_numpy", "numpy"])
def test_torch_plan_matches_numpy_pipelines(plans, other):
    got, want = plans["torch"], plans[other]
    assert got.tput_goal == pytest.approx(want.tput_goal)
    assert got.cost_per_gb == pytest.approx(want.cost_per_gb, abs=1e-6)
    np.testing.assert_array_equal(got.N, want.N)
    assert got.validate() == [] and want.validate() == []


def test_port_numpy_backend_is_the_reference_numpy_backend(plans):
    got, want = plans["numpy"], plans["ref_numpy"]
    assert got.tput_goal == want.tput_goal
    assert got.cost_per_gb == want.cost_per_gb
    np.testing.assert_array_equal(got.N, want.N)
    np.testing.assert_array_equal(got.M, want.M)
    np.testing.assert_array_equal(got.F, want.F)


def test_replan_builds_no_lp_structure(plans):
    """A cost-min re-plan at the chosen throughput rides the structures
    the sweep cached and lands on the sweep's plan."""
    assert plans["replan_builds"] == 0
    again = plans["replan"]
    np.testing.assert_array_equal(again.N, plans["torch"].N)
    assert again.cost_per_gb == pytest.approx(plans["torch"].cost_per_gb,
                                              abs=1e-6)
    assert REGISTRY.counter("planner.struct_builds") is milp._struct_builds


def test_grid_fingerprints_match_reference():
    assert grid_fingerprint(default_topology()) == ref_fingerprint(
        ref_default()
    )
    for seed in range(2):
        assert grid_fingerprint(toy_topology(seed=seed)) == ref_fingerprint(
            ref_toy(seed=seed)
        )


def test_torch_backend_needs_a_device_or_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("with a card present, device=None is the card")
    planner = Planner(toy_topology(n=5, seed=0))
    spec = PlanSpec(objective="cost_min", src="toy:r0", dst="toy:r1",
                    tput_goal_gbps=1.0, volume_gb=1.0, backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        planner.plan(spec)
    with pytest.raises(ValueError):
        planner.plan(PlanSpec(objective="pareto", src="toy:r0",
                              dst="toy:r1", volume_gb=1.0, backend="jax"))
