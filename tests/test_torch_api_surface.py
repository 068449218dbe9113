"""The port's public names are the reference package's.

``__all__`` of ``transfer``, ``calibrate``, ``core``, ``obs``, ``ckpt``,
``models``, ``sharding`` and ``analysis`` equals the reference's
(``ckpt``, ``models`` and ``sharding`` have no ``__all__`` there: their
public names are what their ``__init__`` imports). The only names left out are
listed below, so that the slice that ports them removes them from the
list.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import types
from pathlib import Path

import pytest

# every module of the reference's transfer plane is ported
NOT_PORTED_YET: dict[str, set] = {}
# the reference's deprecated per-engine shims: the port reaches every
# engine through simulate(engine=...) and does not copy them; and its
# gauge and histogram, which nothing in the port creates
NOT_COPIED = {"transfer": {"simulate_multi", "simulate_multi_reference"},
              "obs": {"Gauge", "Histogram"}}
PACKAGES = ("transfer", "calibrate", "core", "obs", "ckpt", "models",
            "sharding", "analysis")


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


MODEL_MODULES = ("attention", "layers", "model", "moe", "params", "ssm",
                 "transformer")


@pytest.mark.parametrize("mod", MODEL_MODULES)
def test_model_modules_define_the_reference_functions(mod):
    """Every public function and class a module of ``models`` defines in
    the reference, its port defines too (``ssm.ssm_cache_logical``, which
    ``models/__init__`` exports in neither package, among them)."""
    ref = importlib.import_module(f"repro.models.{mod}")
    port = importlib.import_module(f"repro_torch.models.{mod}")
    want = {n for n, v in vars(ref).items()
            if not n.startswith("_") and (inspect.isfunction(v)
                                          or inspect.isclass(v))
            and v.__module__ == ref.__name__}
    assert want <= set(vars(port)), want - set(vars(port))


def test_left_out_names_are_absent():
    import repro_torch.obs as obs
    import repro_torch.transfer as t
    from repro_torch.obs import metrics
    from repro_torch.transfer import flowsim, flowsim_ref

    for name in NOT_PORTED_YET.get("transfer", set()) | NOT_COPIED["transfer"]:
        assert not hasattr(t, name), name
    for name in NOT_COPIED["obs"]:
        assert not hasattr(obs, name) and not hasattr(metrics, name), name
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


# ------------------------------------------------------ module coverage
SRC = Path(__file__).resolve().parents[1] / "src"
# reference module -> its port, where the port's file has another name
RENAMED = {
    "core/solver/ipm_jax.py": "core/solver/ipm_torch.py",
    "transfer/flowsim_jax.py": "transfer/flowsim_torch.py",
}
# the Pallas kernels: each becomes CUDA C++ sources in its package's csrc/
PALLAS = ("kernels/flash_attention/flash_attention.py",
          "kernels/quantize/quantize.py", "kernels/ssd_scan/ssd_scan.py",
          "kernels/waterfill/waterfill.py")


def _modules(root: Path) -> set:
    return {p.relative_to(root).as_posix() for p in root.rglob("*.py")}


def test_every_reference_module_has_its_port():
    """Every ``.py`` module of ``src/repro`` has a counterpart in
    ``src/repro_torch``: the same path, or its port's name."""
    port = _modules(SRC / "repro_torch")
    missing = []
    for mod in sorted(_modules(SRC / "repro")):
        if mod in PALLAS:
            if not list((SRC / "repro_torch" / mod).parent.glob("csrc/*.cu")):
                missing.append(mod)
        elif RENAMED.get(mod, mod) not in port:
            missing.append(mod)
    assert not missing, missing


def _defined(path: Path) -> set:
    """The public names a module's source defines at its top level."""
    import ast

    out = set()
    for node in ast.parse(path.read_text(encoding="utf-8")).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


# what the dry run's port adds to the reference's names: the ring formulas'
# one home and the recorder; a step counted on any mesh (chip_smoke's
# one-rank count)
PORT_ADDED = {
    "launch/hlo_stats.py": {"wire_bytes", "StepRecorder"},
    "launch/dryrun.py": {"count_step"},
}


@pytest.mark.parametrize("mod", sorted(PORT_ADDED))
def test_dryrun_modules_define_the_reference_names(mod):
    """Read from the sources: the reference's ``launch/dryrun.py`` sets
    ``XLA_FLAGS`` when imported."""
    want = _defined(SRC / "repro" / mod) | PORT_ADDED[mod]
    assert _defined(SRC / "repro_torch" / mod) == want
