"""The port's copies of the reference's small numpy and stdlib modules,
held equal to the reference on the same inputs: the RON baseline
(``core/ron.py``), the plan CLI (``launch/plan.py``), Skytrace's export
and its CLI (``obs/export.py``, ``obs/__main__.py``) and the per-arch
config stubs (``configs/<arch>.py``). Shard placement is held in
``test_torch_gateway.py``."""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import default_topology, ron_plan
from repro.obs import export as ref_export
from repro.obs.__main__ import trace_chaos_scenario as ref_chaos_trace
from repro_torch import convert
from repro_torch.core import default_topology as port_default
from repro_torch.core import ron_plan as port_ron_plan
from repro_torch.obs import export as port_export
from repro_torch.obs.__main__ import trace_chaos_scenario

ROOT = Path(__file__).resolve().parents[1]
ARCH_MODULES = sorted(
    p.stem for p in (ROOT / "src" / "repro" / "configs").glob("*.py")
    if p.stem not in ("__init__", "archs", "base", "shapes")
)


def _same_plan(a, b):
    sa, sb = convert.plan_state(a), convert.plan_state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        if hasattr(sa[k], "shape"):
            assert (sa[k] == sb[k]).all() and sa[k].shape == sb[k].shape, k
        else:
            assert sa[k] == sb[k], k


@pytest.mark.parametrize("route,num_vms", [
    (("azure:canadacentral", "gcp:asia-northeast1"), 8),
    (("aws:us-east-1", "aws:ap-southeast-2"), 4),
    (("gcp:us-central1", "aws:eu-central-1"), 1),
])
def test_ron_plan_equals_reference(route, num_vms):
    got = port_ron_plan(port_default(), *route, 50.0, num_vms=num_vms)
    want = ron_plan(default_topology(), *route, 50.0, num_vms=num_vms)
    _same_plan(got, want)
    assert got.validate() == [] and got.throughput > 0


@pytest.mark.parametrize("args", [
    ["--src", "azure:canadacentral", "--dst", "gcp:asia-northeast1",
     "--volume-gb", "50", "--tput-floor", "4"],
    ["--src", "aws:us-east-1", "--dst", "aws:ap-southeast-2",
     "--volume-gb", "16", "--cost-ceiling-x", "1.15", "--max-relays", "4",
     "--simulate"],
])
def test_plan_cli_prints_the_reference_json(args, capsys):
    from repro.launch.plan import main as ref_main
    from repro_torch.launch.plan import main

    rc = main(args + ["--json"])
    got = capsys.readouterr().out
    ref_rc = ref_main(args + ["--json"])
    want = capsys.readouterr().out
    assert got == want and rc == ref_rc
    assert json.loads(got)["plan_gbps"] > 0


@pytest.mark.parametrize("reference", [False, True], ids=["soa", "ref"])
def test_trace_json_is_byte_equal(reference):
    """The seeded chaos trace of ``python -m repro_torch.obs`` equals the
    reference's, and so do its three renderings of the same events."""
    kw = {"seed": 5, "volume_gb": 0.5, "horizon_s": 8.0,
          "reference": reference}
    got, want = trace_chaos_scenario(**kw), ref_chaos_trace(**kw)
    assert len(got) > 10 and {e[4] for e in got} == {"sim"}
    assert port_export.trace_json(got) == ref_export.trace_json(want)
    assert port_export.trace_json(want) == ref_export.trace_json(want)
    assert port_export.to_chrome_trace(want) == \
        ref_export.to_chrome_trace(want)
    assert port_export.text_timeline(want, limit=50) == \
        ref_export.text_timeline(want, limit=50)


def test_obs_cli_export_is_byte_equal_to_reference(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = {}
    for pkg in ("repro", "repro_torch"):
        out = tmp_path / f"{pkg}.json"
        res = subprocess.run(
            [sys.executable, "-m", f"{pkg}.obs", "--seed", "9",
             "--volume-gb", "0.5", "--horizon-s", "8", "--out", str(out)],
            env=env, capture_output=True, text=True, timeout=300,
        )
        assert res.returncode == 0, res.stderr
        outs[pkg] = out.read_bytes()
    assert outs["repro_torch"] == outs["repro"]
    assert json.loads(outs["repro"])["traceEvents"][0]["ph"] == "M"


@pytest.mark.parametrize("name", ARCH_MODULES)
def test_arch_config_stubs_equal_reference(name):
    got = importlib.import_module(f"repro_torch.configs.{name}")
    want = importlib.import_module(f"repro.configs.{name}")
    for attr in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(got, attr)) == \
            dataclasses.asdict(getattr(want, attr)), attr


def test_every_arch_has_its_stub():
    from repro_torch.configs import ARCHS

    stubs = {n.replace("_", "").replace("-", "") for n in ARCH_MODULES}
    assert len(ARCH_MODULES) == len(ARCHS) == 10
    assert {a.replace("-", "").replace("_", "").replace(".", "")
            for a in ARCHS} == stubs
