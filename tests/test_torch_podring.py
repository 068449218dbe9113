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
1e-2 of the uncompressed run's.

The same step on inner-sharded DTensors: four gloo CPU ranks (one spawn)
run smollm-135m's 3 steps on ``make_mesh_for(2, 2, 1)`` and
``make_mesh_for(2, 1, 2)``, parameters and moments placed by
``make_param_shardings`` (replicated over "pod"), each pod on its
("data", "model") sub-mesh and the ring on each rank's local shards. In
f32 with the raw wire, the losses and the gradients AdamW is handed at
every step equal the pod-only run's above within 1e-5 of each leaf's
largest entry, and the parameters after the steps equal AdamW replayed
on those gradients within 1e-5; all four ranks hold the same
parameters. The
reference's own ``make_podring_train_step`` on the same two meshes (4
host devices, in a subprocess) gives the losses within 1e-4 and the
parameters within AdamW's bound, and the int8 wire stays within the
bound above.

The reference runs in the parent (and its pod ring in a subprocess)
while the ranks run; the ranks import this file, which imports no jax at
module level.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import TRAIN_CPU_TOL  # noqa: E402

ARCHS = ("smollm-135m", "qwen2-7b")
B, S, CHUNK, STEPS = 4, 32, 16, 3
OPT = dict(warmup_steps=1, total_steps=STEPS)
SHARDED_ARCH = "smollm-135m"
MESHES = ((2, 2, 1), (2, 1, 2))
SHARDED_TOL = 1e-5


def _tcfg(arch: str):
    from repro_torch.configs import ARCHS as T_ARCHS
    from repro_torch.configs import reduced

    return dataclasses.replace(reduced(T_ARCHS[arch]), dtype="float32",
                               loss_chunk=CHUNK)


def _full_state(tree) -> dict:
    """A tree of tensors or DTensors as numpy arrays by dotted path, each
    DTensor gathered whole."""
    from repro_torch import convert
    from repro_torch.sharding.specs import is_dtensor
    from repro_torch.tree import tree_map

    return convert.params_state(tree_map(
        lambda t: t.full_tensor() if is_dtensor(t) else t, tree))


def _run(step, params, opt, batches, place=lambda b: b) -> dict:
    """The steps, each batch through ``place``: losses, the gradients AdamW
    was handed at each step, the final parameters (numpy by dotted path)
    and the step count."""
    from repro_torch import convert
    from repro_torch.train import train_step

    grads, adamw = [], train_step.adamw_update

    def recorded(g, *args):
        grads.append(_full_state(g))
        return adamw(g, *args)

    train_step.adamw_update = recorded
    try:
        losses = []
        for b in batches:
            params, opt, m = step(params, opt,
                                  place(convert.batch_from_numpy(b, "cpu")))
            losses.append(float(m["loss"]))
    finally:
        train_step.adamw_update = adamw
    return {"losses": losses, "grads": grads,
            "params": _full_state(params), "step": int(opt["step"])}


def _ranks(rank, world, states, batches):
    """Both archs, both wire modes, on this rank (the pod-only mesh)."""
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
            step = make_podring_train_step(_tcfg(arch), rules,
                                           OptConfig(**OPT), mesh,
                                           compress_wire=comp)
            out[arch, comp] = _run(step, params, init_opt_state(params),
                                   batches[arch])
    return out


def _sharded_ranks(rank, world, state, batches):
    """SHARDED_ARCH on each of MESHES, both wire modes, on this rank:
    DTensor parameters and moments, the batch placed as the dry run places
    it. Also counts the parameters that a mesh axis shards."""
    from torch.distributed.tensor import Shard

    from repro_torch import convert
    from repro_torch.launch.inputs import train_batch_logical
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.model import abstract_params
    from repro_torch.sharding.specs import (ShardingRules, device_put,
                                            make_param_shardings, set_mesh,
                                            shardings_for)
    from repro_torch.train import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_podring_train_step
    from repro_torch.tree import tree_leaves

    cfg = _tcfg(SHARDED_ARCH)
    rules = ShardingRules(batch=("pod", "data"), fsdp="data", tp="model")
    out = {}
    for shape in MESHES:
        mesh = make_mesh_for(*shape, device="cpu")
        set_mesh(mesh)

        def place(b):
            return device_put(b, shardings_for(mesh, rules,
                                               train_batch_logical(cfg), b))

        for comp in (False, True):
            params = device_put(
                convert.params_from_state(state, "cpu"),
                make_param_shardings(mesh, rules, abstract_params(cfg)))
            step = make_podring_train_step(cfg, rules, OptConfig(**OPT),
                                           mesh, compress_wire=comp)
            out[shape, comp] = _run(step, params, init_opt_state(params),
                                    batches, place)
            out[shape, comp]["sharded_leaves"] = sum(
                any(isinstance(pl, Shard) for pl in p.placements)
                for p in tree_leaves(params))
        set_mesh(None)
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


# the reference's pod ring on MESHES (4 host devices), raw wire, from the
# parameters of ``_reference_inputs``: argv[1] holds its inputs, argv[2]
# gets {mesh: losses and final parameters}
REF_RING = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp
from repro import configs
from repro.launch.mesh import make_mesh_for
from repro.models import init_params
from repro.sharding.specs import ShardingRules, set_mesh
from repro.train.optimizer import OptConfig, init_opt_state
from repro.train.train_step import make_podring_train_step
from repro_torch import convert

with open(sys.argv[1], "rb") as f:
    arch, chunk, opt_kw, meshes, batches = pickle.load(f)
cfg = dataclasses.replace(configs.reduced(configs.ARCHS[arch]),
                          dtype="float32", loss_chunk=chunk)
rules = ShardingRules(batch=("pod", "data"), fsdp="data", tp="model")
out = {}
for shape in meshes:
    mesh = make_mesh_for(*shape)
    set_mesh(mesh)
    params = init_params(cfg, jax.random.PRNGKey(3))
    opt = init_opt_state(params)
    step = jax.jit(make_podring_train_step(cfg, rules, OptConfig(**opt_kw),
                                           mesh, compress_wire=False))
    losses = []
    with mesh:
        for b in batches:
            params, opt, m = step(params, opt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    out[shape] = {"losses": losses, "params": convert.params_state(params)}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": {arch: reference}, "port": [rank results], "sharded": [rank
    results], "ref_ring": {mesh: reference pod ring}}: the ranks and the
    reference's pod ring start as soon as the inputs exist and run while
    the reference steps."""
    from repro_torch.launch.ranks import spawn_ranks

    ref = {arch: _reference_inputs(arch) for arch in ARCHS}
    tmp = tmp_path_factory.mktemp("podring")
    batches = ref[SHARDED_ARCH]["batches"]
    with open(tmp / "ring_in.pkl", "wb") as f:
        pickle.dump((SHARDED_ARCH, CHUNK, OPT, MESHES, batches), f)
    ring = subprocess.Popen(
        [sys.executable, "-c", REF_RING, str(tmp / "ring_in.pkl"),
         str(tmp / "ring_out.pkl")], cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port: list = []
    sharded: list = []
    threads = [threading.Thread(target=lambda: port.extend(spawn_ranks(
        _ranks, 2, ({a: ref[a]["state"] for a in ARCHS},
                    {a: ref[a]["batches"] for a in ARCHS}), workdir=tmp))),
        threading.Thread(target=lambda: sharded.extend(spawn_ranks(
            _sharded_ranks, 4, (ref[SHARDED_ARCH]["state"], batches),
            workdir=tmp)))]
    for t in threads:
        t.start()
    try:
        for arch in ARCHS:
            _reference_steps(ref[arch])
        log, _ = ring.communicate(timeout=600)
    finally:
        for t in threads:
            t.join()
    assert ring.returncode == 0, log[-3000:]
    assert len(port) == 2 and len(sharded) == 4, "the ranks failed"
    with open(tmp / "ring_out.pkl", "rb") as f:
        ref_ring = pickle.load(f)
    return {"ref": ref, "port": port, "sharded": sharded,
            "ref_ring": ref_ring}


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


# ------------------------------------------- the inner-sharded pod ring
def _far(got: dict, want: dict, tol: float) -> dict:
    """{leaf: worst gap / the leaf's largest |want|} of the leaves where
    that exceeds ``tol``."""
    out = {}
    for k, w in want.items():
        gap = float(np.abs(got[k] - w).max(initial=0.0))
        out[k] = gap / max(float(np.abs(w).max()), 1e-30)
    return {k: v for k, v in out.items() if v > tol}


def _adamw_replay(state: dict, grads: list) -> dict:
    """The port's AdamW on plain tensors from ``state``, fed ``grads``
    (one tree a step, numpy by dotted path): the parameters after."""
    from repro_torch import convert
    from repro_torch.train import OptConfig, init_opt_state
    from repro_torch.train.optimizer import adamw_update

    params = convert.params_from_state(state, "cpu")
    opt = init_opt_state(params)
    for g in grads:
        params, opt, _ = adamw_update(convert.params_from_state(g, "cpu"),
                                      params, opt, OptConfig(**OPT))
    return convert.params_state(params)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_inner_sharded_podring_equals_the_pod_only_step(runs, mesh):
    """f32, raw wire: the losses and the gradients AdamW is handed at every
    step equal the pod-only run's within SHARDED_TOL of each leaf's
    largest entry, on every rank; the parameters equal AdamW replayed on
    plain tensors from the same start with the run's own gradients within
    SHARDED_TOL, and the pod-only run's within AdamW's step bound (AdamW
    divides each entry's gradient by its own root mean square, so a small
    entry's share of the gradients' 1e-6-relative reduction-order noise
    moves its update by more than that share of the leaf's largest)."""
    pod_only = runs["port"][0][SHARDED_ARCH, False]
    start = runs["ref"][SHARDED_ARCH]["state"]
    allowed = TRAIN_CPU_TOL["adam_steps"] * _lr_sum()
    for out in runs["sharded"]:
        got = out[mesh, False]
        assert got["step"] == STEPS and got["sharded_leaves"] > 0
        np.testing.assert_allclose(got["losses"], pod_only["losses"],
                                   rtol=SHARDED_TOL)
        for g, w in zip(got["grads"], pod_only["grads"], strict=True):
            assert not _far(g, w, SHARDED_TOL)
        assert not _far(got["params"], _adamw_replay(start, got["grads"]),
                        SHARDED_TOL)
        for k, w in pod_only["params"].items():
            gap = float(np.abs(got["params"][k] - w).max(initial=0.0))
            assert gap <= allowed, (k, gap, allowed)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_inner_sharded_podring_ranks_agree(runs, mesh):
    first = runs["sharded"][0]
    for out in runs["sharded"][1:]:
        for comp in (False, True):
            assert out[mesh, comp]["losses"] == first[mesh, comp]["losses"]
            for k, v in first[mesh, comp]["params"].items():
                np.testing.assert_array_equal(
                    out[mesh, comp]["params"][k], v, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_inner_sharded_podring_matches_the_references(runs, mesh):
    """Against the reference's pod ring on the same mesh and its whole-
    batch step: losses 1e-4, parameters within AdamW's step bound."""
    allowed = TRAIN_CPU_TOL["adam_steps"] * _lr_sum()
    got = runs["sharded"][0][mesh, False]
    for ref in (runs["ref_ring"][mesh], runs["ref"][SHARDED_ARCH]):
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
        for k, w in ref["params"].items():
            gap = float(np.abs(got["params"][k] - w).max(initial=0.0))
            assert gap <= allowed, (k, gap, allowed)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_inner_sharded_podring_int8_wire_stays_close(runs, mesh):
    for out in runs["sharded"]:
        raw, comp = out[mesh, False]["losses"], out[mesh, True]["losses"]
        np.testing.assert_allclose(comp, raw, rtol=0, atol=1e-2)
        assert comp != raw  # the wire was quantized
