"""The sim-step kernels' wrappers and the sim's layout, on the CPU.

The kernels (``kernels/simstep/csrc/simstep.cu``) run only on the card,
where ``tests/test_torch_cuda_kernels.py`` holds the card's sim against
the CPU's. Here: the ctypes struct against the source's, every sim
scenario's tensors against the kernels' dtypes and shapes, the wrappers'
refusals, and that a CPU sim never loads the library (the CPU's plain
version is the torch ops of ``transfer/flowsim_torch.py``).
"""

from __future__ import annotations

import ctypes
import re

import pytest
import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.simstep import build as ss_build
from repro_torch.kernels.simstep import ops as ss
from repro_torch.obs.metrics import REGISTRY
from repro_torch.transfer import flowsim_torch, simulate
from repro_torch.transfer.events import materialize_jobs, sorted_schedule
from repro_torch.transfer.simconfig import resolve

from test_torch_cases import SIM_SCENARIOS, fleet_jobs, sim_scenario
from test_torch_cases import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def port_top():
    from repro_torch.core import default_topology

    return default_topology()


def _state(jobs, faults, kw, solver="f64"):
    cfg = resolve(None, **{k: v for k, v in kw.items()
                           if k not in ("rate_solver", "block")})
    su = materialize_jobs(jobs, seed=0)
    return flowsim_torch._build(su, cfg, sorted_schedule(jobs, faults),
                                solver, "cpu")


def test_args_struct_is_the_sources():
    """``ops.SimArgs`` lists the members of ``csrc/simstep.cu``'s
    ``SimArgs`` in order, pointers as pointers, and the scalars with the
    source's types."""
    src = ss_build.SOURCE.read_text()
    body = re.search(r"struct SimArgs \{(.*?)\n\};", src, re.S).group(1)
    members = re.findall(r"^\s+([\w\s]+?\*?)\s*(\w+);", body, re.M)
    assert [name for _, name in members] == list(ss.FIELDS)
    kinds = {"double": ctypes.c_double, "long long": ctypes.c_longlong,
             "int": ctypes.c_int}
    for (ctype, name), (fname, ftype) in zip(members, ss.SimArgs._fields_):
        assert name == fname
        want = ctypes.c_void_p if ctype.endswith("*") else kinds[ctype]
        assert ftype is want, name


@pytest.mark.parametrize("name", SIM_SCENARIOS)
def test_every_scenario_lays_out_its_state_as_the_kernels_read_it(
        name, port_top):
    """Each sim scenario's state, constants and scratch pass the kernels'
    checks: dtype, shape and contiguity of every tensor, one device."""
    jobs, faults, kw = sim_scenario(name, port_top)
    sc, cn, st = _state(jobs, faults, kw)
    tensors, knobs = flowsim_torch._step_inputs(st, cn, sc)
    held = ss.check(tensors, knobs, ss.scratch(sc.ncp, "cpu"))
    assert list(held) == [n for n, _, _ in ss.TENSORS]
    assert knobs["hz_eps"] == sc.horizon - flowsim_torch.T_EPS
    assert knobs["nseg"] + 1 == held["je_off"].numel()
    assert cn.step is None  # the CPU binds nothing


def test_the_fleet_state_is_laid_out_as_the_kernels_read_it(port_top):
    """48 jobs of 8 VMs x 64 connections: lanes past the block's 1,024
    threads, the same layout."""
    sc, cn, st = _state(fleet_jobs(port_top, 48), [], {})
    assert sc.ncp > 1024
    ss.check(*flowsim_torch._step_inputs(st, cn, sc),
             ss.scratch(sc.ncp, "cpu"))


def test_check_refuses_what_the_kernels_do_not_take(port_top):
    jobs, faults, kw = sim_scenario("plain", port_top)
    sc, cn, st = _state(jobs, faults, kw)
    tensors, knobs = flowsim_torch._step_inputs(st, cn, sc)
    scr = ss.scratch(sc.ncp, "cpu")
    bad = {
        "remaining": (TypeError, st.remaining.float()),
        "chunk_arr": (ValueError, st.chunk_arr[:-1]),
        "ready_buf": (ValueError, st.ready_buf.t().contiguous().t()),
        "arrived": (ValueError, st.arrived.to("meta")),
    }
    for name, (err, t) in bad.items():
        with pytest.raises(err, match=name):
            ss.check({**tensors, name: t}, knobs, scr)
    with pytest.raises(KeyError, match="conn_first"):
        ss.check({k: v for k, v in tensors.items() if k != "conn_first"},
                 knobs, scr)
    with pytest.raises(KeyError, match="hz_eps"):
        ss.check(tensors, {k: v for k, v in knobs.items() if k != "hz_eps"},
                 scr)
    with pytest.raises(ValueError, match="on the card"):
        ss.bind(tensors, knobs, scr)


@pytest.mark.parametrize("name", SIM_SCENARIOS)
def test_cpu_sim_never_loads_the_sim_step_library(name, port_top,
                                                  monkeypatch):
    """A CPU sim runs the torch ops (the plain version): it builds, loads
    and launches nothing of ``kernels/simstep``, and binds no state."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU sim reached the sim-step library")

    monkeypatch.setattr(ss_build.LIBRARY, "load", refuse)
    monkeypatch.setattr(ss_build.LIBRARY, "start", refuse)
    monkeypatch.setattr(nvcc, "build_all", refuse)
    monkeypatch.setattr(ss, "sim_pre_f64", refuse)
    monkeypatch.setattr(ss, "sim_post_f64", refuse)
    before = REGISTRY.snapshot(("kernels.sim_",))
    jobs, faults, kw = sim_scenario(name, port_top)
    res = simulate(jobs, faults, device="cpu", **kw)
    assert res.events > 0
    assert ss_build.LIBRARY.lib is None
    assert REGISTRY.snapshot(("kernels.sim_",)) == before


def test_scratch_is_zeroed_and_sized_by_the_lanes():
    scr = ss.scratch(40, "cpu")
    assert all(t.shape == () for t in (scr.go, scr.run, scr.changed))
    for t in (scr.active, scr.w, scr.excl, scr.lane_ch, scr.lane_flags,
              scr.ord, scr.ord_on):
        assert t.shape == (40,) and not t.any()
    assert scr.lane_flags.dtype == torch.uint8
