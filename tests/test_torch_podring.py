"""The port's pod-ring train step against the reference's whole-batch step.

Two gloo CPU ranks (one spawn for the file) run
``make_podring_train_step`` on ``make_mesh_for(2, 1, 1)`` for 3 steps of
reduced smollm-135m and qwen2-7b in f32, each rank on its half of the
same 4-row batches, from the reference's parameters (carried over by
``repro_torch.convert``). Uncompressed, the pod mean of the two halves'
gradients is the whole batch's gradient, so the run is held against the
reference's jitted ``make_train_step`` on the whole batch: losses within
1e-4 (relative), parameters within the bound AdamW's own step allows
(``chip_smoke.TRAIN_CPU_TOL``: 2.01 times the sum of the learning rates;
an entry's update is about +-lr whatever its gradient's size), and both
ranks' parameters bit-identical. With int8 on the wire the two ranks stay
bit-identical (the reference's 2-pod claim) and the losses stay within
1e-2 of the uncompressed run's. The reference runs in the parent while
the ranks run; the ranks import this file, which imports no jax at module
level.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import TRAIN_CPU_TOL  # noqa: E402

ARCHS = ("smollm-135m", "qwen2-7b")
B, S, CHUNK, STEPS = 4, 32, 16, 3
OPT = dict(warmup_steps=1, total_steps=STEPS)


def _tcfg(arch: str):
    from repro_torch.configs import ARCHS as T_ARCHS
    from repro_torch.configs import reduced

    return dataclasses.replace(reduced(T_ARCHS[arch]), dtype="float32",
                               loss_chunk=CHUNK)


def _ranks(rank, world, states, batches):
    """Both archs, both wire modes, on this rank: losses and the final
    parameters (numpy, by dotted path)."""
    from repro_torch import convert
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.sharding.specs import ShardingRules
    from repro_torch.train import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_podring_train_step

    mesh = make_mesh_for(world, 1, 1, device="cpu")
    rules = ShardingRules(batch=None, fsdp=None, tp=None)
    out = {}
    for arch in ARCHS:
        for comp in (False, True):
            params = convert.params_from_state(states[arch], "cpu")
            opt = init_opt_state(params)
            step = make_podring_train_step(_tcfg(arch), rules,
                                           OptConfig(**OPT), mesh,
                                           compress_wire=comp)
            losses = []
            for b in batches[arch]:
                params, opt, m = step(params, opt,
                                      convert.batch_from_numpy(b, "cpu"))
                losses.append(float(m["loss"]))
            out[arch, comp] = {"losses": losses,
                               "params": convert.params_state(params),
                               "step": int(opt["step"])}
    return out


def _reference_inputs(arch: str) -> dict:
    """The reference's config, parameters (and their numpy state) and the
    pipeline's batches."""
    import jax

    from repro import configs
    from repro.data.pipeline import ShardedTokenPipeline
    from repro.models import init_params
    from repro_torch import convert

    cfg = dataclasses.replace(configs.reduced(configs.ARCHS[arch]),
                              dtype="float32", loss_chunk=CHUNK)
    params = init_params(cfg, jax.random.PRNGKey(3))
    pipe = ShardedTokenPipeline(cfg, global_batch=B, seq_len=S, seed=5)
    return {"cfg": cfg, "jparams": params,
            "state": convert.params_state(params),
            "batches": [next(pipe) for _ in range(STEPS)]}


def _reference_steps(ref: dict) -> None:
    """The jitted whole-batch step's losses and final parameters."""
    import jax
    import jax.numpy as jnp

    from repro.sharding.specs import ShardingRules
    from repro.train.optimizer import OptConfig, init_opt_state
    from repro.train.train_step import make_train_step
    from repro_torch import convert

    step = jax.jit(make_train_step(
        ref["cfg"], ShardingRules(batch=None, fsdp=None, tp=None),
        OptConfig(**OPT)))
    params = ref.pop("jparams")
    opt = init_opt_state(params)
    ref["losses"] = []
    for b in ref["batches"]:
        params, opt, m = step(params, opt,
                              {k: jnp.asarray(v) for k, v in b.items()})
        ref["losses"].append(float(m["loss"]))
    ref["params"] = convert.params_state(params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": {arch: reference}, "port": [rank results]}: the ranks start
    as soon as the inputs exist and run while the reference steps."""
    from repro_torch.launch.ranks import spawn_ranks

    ref = {arch: _reference_inputs(arch) for arch in ARCHS}
    tmp = tmp_path_factory.mktemp("podring")
    port: list = []
    ranks = threading.Thread(target=lambda: port.extend(spawn_ranks(
        _ranks, 2, ({a: ref[a]["state"] for a in ARCHS},
                    {a: ref[a]["batches"] for a in ARCHS}), workdir=tmp)))
    ranks.start()
    try:
        for arch in ARCHS:
            _reference_steps(ref[arch])
    finally:
        ranks.join()
    assert len(port) == 2, "the ranks failed"
    return {"ref": ref, "port": port}


def _lr_sum() -> float:
    from repro_torch.train import OptConfig
    from repro_torch.train.optimizer import schedule

    return sum(float(schedule(OptConfig(**OPT), torch.tensor(t)))
               for t in range(1, STEPS + 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_podring_losses_match_the_whole_batch_step(runs, arch):
    want = runs["ref"][arch]["losses"]
    for out in runs["port"]:
        got = out[arch, False]
        assert got["step"] == STEPS
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_podring_parameters_within_adamw_step_bound(runs, arch):
    want = runs["ref"][arch]["params"]
    allowed = TRAIN_CPU_TOL["adam_steps"] * _lr_sum()
    moved = 0.0
    for out in runs["port"]:
        got = out[arch, False]["params"]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            gap = float(np.abs(got[k] - w).max(initial=0.0))
            assert gap <= allowed, (k, gap, allowed)
            moved = max(moved, float(np.abs(
                runs["ref"][arch]["state"][k] - w).max(initial=0.0)))
    assert moved > allowed / 10  # the steps moved the parameters


@pytest.mark.parametrize("comp", [False, True], ids=["raw", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_podring_ranks_hold_bit_identical_parameters(runs, arch, comp):
    a, b = (out[arch, comp] for out in runs["port"])
    assert a["losses"] == b["losses"]
    for k, v in a["params"].items():
        np.testing.assert_array_equal(v, b["params"][k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_podring_int8_wire_losses_stay_close(runs, arch):
    for out in runs["port"]:
        raw, comp = out[arch, False]["losses"], out[arch, True]["losses"]
        np.testing.assert_allclose(comp, raw, rtol=0, atol=1e-2)
        assert comp != raw  # the wire was quantized


def test_podring_step_needs_a_pod_axis():
    from repro_torch.sharding.specs import ShardingRules
    from repro_torch.train import OptConfig
    from repro_torch.train.train_step import make_podring_train_step

    class _FakeMesh:
        axis_names = ("data", "model")
        devices = np.empty((2, 2))

    with pytest.raises(ValueError, match="no pod axis"):
        make_podring_train_step(_tcfg("smollm-135m"), ShardingRules(),
                                OptConfig(), _FakeMesh())
