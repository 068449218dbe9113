"""The port's public names are the reference package's.

``__all__`` of ``transfer``, ``calibrate``, ``core``, ``obs``, ``ckpt``
and ``models`` equals the reference's (``ckpt`` and ``models`` have no
``__all__`` there: their public names are what their ``__init__``
imports). The only names left out are
listed below, so that the slice that ports them removes them from the
list.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import types

import pytest

# every module of the reference's transfer plane is ported
NOT_PORTED_YET: dict[str, set] = {}
# the reference's deprecated per-engine shims: the port reaches every
# engine through simulate(engine=...) and does not copy them
NOT_COPIED = {"transfer": {"simulate_multi", "simulate_multi_reference"}}
PACKAGES = ("transfer", "calibrate", "core", "obs", "ckpt", "models")


def _public(mod) -> set:
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and n != "annotations"}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_all_equals_reference(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    left_out = NOT_PORTED_YET.get(pkg, set()) | NOT_COPIED.get(pkg, set())
    assert left_out <= _public(ref)
    assert set(port.__all__) == _public(ref) - left_out


@pytest.mark.parametrize("pkg", PACKAGES)
def test_all_names_resolve(pkg):
    port = importlib.import_module(f"repro_torch.{pkg}")
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_left_out_names_are_absent():
    import repro_torch.transfer as t
    from repro_torch.transfer import flowsim, flowsim_ref

    for name in NOT_PORTED_YET.get("transfer", set()) | NOT_COPIED["transfer"]:
        assert not hasattr(t, name), name
    assert not hasattr(flowsim, "simulate_multi")
    assert not hasattr(flowsim_ref, "simulate_multi_reference")


@pytest.mark.parametrize("cls", [
    "TransferRequest", "BackoffLadder", "DegradationLadder", "ReplanRecord",
    "JobReport", "ServiceReport", "BreakerConfig", "BreakerTransition",
    "GatewayReport", "SimConfig",
])
def test_dataclass_fields_equal_reference(cls):
    import repro.transfer as ref
    import repro_torch.transfer as port

    def fields(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]

    if cls == "SimConfig":  # the one field whose default differs
        assert [f for f in fields(port.SimConfig) if f[0] != "engine"] == \
            [f for f in fields(ref.SimConfig) if f[0] != "engine"]
        assert port.SimConfig().engine == "torch"
        return
    assert fields(getattr(port, cls)) == fields(getattr(ref, cls))


@pytest.mark.parametrize("qualname", [
    "calibrate.Incident", "calibrate.BeliefSnapshot", "calibrate.ProbeBudget",
    "calibrate.ProbeRecord", "calibrate.ProbeRound",
    "calibrate.PolicyContext", "calibrate.DriftEvent", "calibrate.EpochRoll",
    "calibrate.CalibratedServiceReport", "transfer.TenantSpec",
    "transfer.TenantReport", "transfer.FleetReport",
])
def test_calibration_dataclass_fields_equal_reference(qualname):
    pkg, cls = qualname.split(".")
    ref = getattr(importlib.import_module(f"repro.{pkg}"), cls)
    port = getattr(importlib.import_module(f"repro_torch.{pkg}"), cls)

    def fields(c):
        return [(f.name, f.default, str(f.default_factory))
                for f in dataclasses.fields(c)]

    assert fields(port) == fields(ref)


def test_fleet_names_resolve_lazily():
    """The four fleet names come from ``transfer/fleet.py`` on first use,
    as the reference's do (PEP 562)."""
    import repro_torch.transfer as t
    from repro_torch.transfer import fleet

    for name in ("FleetController", "FleetReport", "TenantReport",
                 "TenantSpec"):
        assert name not in vars(t) and getattr(t, name) is getattr(fleet, name)
    with pytest.raises(AttributeError, match="no attribute"):
        t.NoSuchName  # noqa: B018


@pytest.mark.parametrize("qualname", [
    "calibrate.DriftModel", "calibrate.BeliefGrid", "calibrate.Calibrator",
    "calibrate.GreedyVoIPolicy", "calibrate.RoundRobinPolicy",
    "calibrate.EpsilonGreedyPolicy", "calibrate.BayesianEVOIPolicy",
    "calibrate.make_policy", "calibrate.CalibratedTransferService",
    "calibrate.CalibratedTransferService.run", "transfer.FleetController",
    "transfer.FleetController.submit", "transfer.FleetController.run",
])
def test_calibration_signatures_equal_reference(qualname):
    pkg, *path = qualname.split(".")

    def get(root):
        obj = importlib.import_module(f"{root}.{pkg}")
        for part in path:
            obj = getattr(obj, part)
        return inspect.signature(obj)

    assert str(get("repro_torch")) == str(get("repro"))


def test_chaos_scenario_signature_equals_reference():
    import repro.transfer as ref
    import repro_torch.transfer as port

    assert inspect.signature(port.ChaosScenario) == \
        inspect.signature(ref.ChaosScenario)


def test_service_signature_is_the_reference_plus_device_and_engine():
    import repro.transfer as ref
    import repro_torch.transfer as port

    got = inspect.signature(port.TransferService).parameters
    want = inspect.signature(ref.TransferService).parameters
    assert [n for n in got if n not in ("device", "engine")] == list(want)
    assert got["backend"].default == "torch" and got["device"].default is None
    assert got["engine"].default == "torch"
    assert inspect.signature(port.TransferService.run) == \
        inspect.signature(ref.TransferService.run)


def test_sim_signatures_equal_reference():
    """The dispatcher takes the reference's knobs plus ``device``; each
    numpy engine's entry takes exactly the reference entry's."""
    from repro.transfer import flowsim as ref_flowsim
    from repro.transfer import flowsim_ref as ref_oracle
    from repro.transfer import sim as ref_sim
    from repro_torch.transfer import flowsim, flowsim_ref, sim

    got = inspect.signature(sim.simulate).parameters
    want = inspect.signature(ref_sim.simulate).parameters
    assert [n for n in got if n != "device"] == list(want)
    assert inspect.signature(flowsim.simulate_multi_soa) == \
        inspect.signature(ref_flowsim._simulate_multi_impl)
    assert inspect.signature(flowsim_ref.simulate_multi_ref) == \
        inspect.signature(ref_oracle._simulate_multi_reference_impl)
    for name in ("simulate_transfer",):
        assert inspect.signature(getattr(flowsim, name)) == \
            inspect.signature(getattr(ref_flowsim, name))
    assert inspect.signature(flowsim_ref.simulate_transfer_reference) == \
        inspect.signature(ref_oracle.simulate_transfer_reference)
