"""The port's sharding rules, meshes and elastic reshard against the
reference's.

The five cases of ``test_sharding_and_elastic.py`` run through both
packages (equal specs, an equal ``ReshardPlan`` field for field), and
``make_param_shardings`` gives, for every arch's abstract parameters on
fake (16, 16) and (2, 16, 16) meshes, the reference's
``logical_to_physical`` of the same leaves. The DTensor side runs on 4
gloo CPU ranks in one spawn: ``reshard_state`` onto ``make_mesh_for(2,
2, 1)`` (every leaf's ``full_tensor()`` equal to its input bit for bit,
each rank's shard the one its placements name), a checkpoint restored
with ``shardings=``, and ``shard_constraint`` on a DTensor and on a plain
tensor. The reference's modules import inside the tests: the spawned
ranks import this file and must not import jax.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.sharding.specs import (
    NamedSharding,
    P,
    ShardingRules,
    logical_to_physical,
    make_param_shardings,
)

OLD = ["aws:us-west-2", "gcp:us-central1"]


class _FakeMesh:
    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


def _ref():
    import repro.sharding.specs as ref

    return ref


# ------------------------------------------ the reference's five cases
def test_nondivisible_dims_fall_back_to_replication():
    mesh = _FakeMesh({"data": 16, "model": 16})
    cases = [(("fsdp", "tp", None), (3584, 28, 128)),
             (("fsdp", "tp"), (3584, 18944))]
    for mod in (_ref(), None):
        rules_cls = mod.ShardingRules if mod else ShardingRules
        l2p = mod.logical_to_physical if mod else logical_to_physical
        rules = rules_cls(batch=("data",), fsdp="data", tp="model")
        spec = l2p(rules, *cases[0], mesh)
        assert spec[0] == "data" and spec[1] is None
        spec = l2p(rules, *cases[1], mesh)
        assert spec[1] == "model"
    ref = _ref()
    for logical, shape in cases:
        assert tuple(logical_to_physical(
            ShardingRules(batch=("data",), fsdp="data", tp="model"),
            logical, shape, mesh)) == tuple(ref.logical_to_physical(
                ref.ShardingRules(batch=("data",), fsdp="data", tp="model"),
                logical, shape, mesh))


def test_axis_never_used_twice():
    mesh = _FakeMesh({"data": 4, "model": 4})
    ref = _ref()
    got = logical_to_physical(
        ShardingRules(batch=("data",), fsdp="data", tp="model"),
        ("fsdp", "fsdp"), (64, 64), mesh)
    want = ref.logical_to_physical(
        ref.ShardingRules(batch=("data",), fsdp="data", tp="model"),
        ("fsdp", "fsdp"), (64, 64), mesh)
    assert got[0] == "data" and got[1] is None
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("sizes", [{"data": 16, "model": 16},
                                   {"pod": 2, "data": 16, "model": 16},
                                   {"model": 8}])
@pytest.mark.parametrize("fsdp_pod", [False, True])
def test_rules_filter_for_mesh(sizes, fsdp_pod):
    mesh = _FakeMesh(sizes)
    kw = dict(batch=("pod", "data"), fsdp="data", tp="model",
              fsdp_pod=fsdp_pod)
    got = ShardingRules(**kw).filter_for_mesh(mesh)
    want = _ref().ShardingRules(**kw).filter_for_mesh(mesh)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if "pod" not in sizes and "data" in sizes:
        assert got.batch in (("data",), "data")


def _plans(cfg_name, old, new, **kw):
    from repro.configs import get_arch as ref_arch
    from repro.configs import reduced as ref_reduced
    from repro.core import default_topology as ref_top
    from repro.launch.elastic import plan_reshard as ref_plan
    from repro_torch.core import default_topology
    from repro_torch.launch.elastic import plan_reshard

    got = plan_reshard(reduced(get_arch(cfg_name)), default_topology(), old,
                       new, **kw)
    want = ref_plan(ref_reduced(ref_arch(cfg_name)), ref_top(), old, new,
                    **kw)
    return got, want


def test_reshard_plan_prices_pod_join():
    got, want = _plans("qwen2-7b", OLD, OLD + ["azure:westeurope"],
                       tput_floor_gbps=5.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = reduced(get_arch("qwen2-7b"))
    assert got.new_pods == 3 and len(got.moves) == 1
    src, dst, gb, tput, cost = got.moves[0]
    assert dst == "azure:westeurope" and src in OLD
    assert gb == pytest.approx(cfg.param_count() * 12 / 1e9, rel=1e-6)
    assert cost > 0 and tput > 0


def test_reshard_noop_on_shrink():
    got, want = _plans("smollm-135m", OLD, OLD[:1])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.moves == [] and got.total_cost == 0.0


# ------------------------------------------------ every arch's shardings
def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("rules_kw", [{}, {"fsdp_pod": True},
                                      {"fsdp": None, "tp": "model"}],
                         ids=["default", "fsdp_pod", "tp_only"])
def test_param_shardings_match_reference_for_every_arch(mesh_name, rules_kw):
    from repro.models.model import abstract_params as ref_abstract
    from repro.models.params import ParamDef as RefDef
    from repro_torch.models import abstract_params

    ref = _ref()
    mesh = _FakeMesh(MESHES[mesh_name])
    rules = ShardingRules(**rules_kw)
    ref_rules = ref.ShardingRules(**rules_kw).filter_for_mesh(mesh)
    for name in ARCHS:
        from repro.configs import get_arch as ref_arch

        got = _leaves(make_param_shardings(mesh, rules,
                                           abstract_params(get_arch(name))))
        want = {k: v for k, v in _leaves(ref_abstract(ref_arch(name))).items()
                if isinstance(v, RefDef)}
        assert got.keys() == want.keys(), name
        for path, shd in got.items():
            pd = want[path]
            assert isinstance(shd, NamedSharding) and shd.mesh is mesh
            assert isinstance(shd.spec, P)
            assert tuple(shd.spec) == tuple(ref.logical_to_physical(
                ref_rules, pd.logical, pd.shape, mesh)), (name, path)


def test_opt_state_logical_and_shardings_for_match_reference():
    from repro.models.model import param_logical as ref_logical
    from repro.configs import get_arch as ref_arch
    from repro.train.optimizer import opt_state_logical as ref_opt_logical
    from repro_torch.models.model import param_logical, param_shape_dtypes
    from repro_torch.sharding.specs import shardings_for
    from repro_torch.train import opt_state_logical

    ref = _ref()
    mesh = _FakeMesh(MESHES["multi_pod"])
    rules = ShardingRules()
    for name in ("smollm-135m", "qwen3-moe-30b-a3b", "zamba2-7b"):
        logical = opt_state_logical(param_logical(get_arch(name)))
        assert logical == ref_opt_logical(ref_logical(ref_arch(name)))
        sds = param_shape_dtypes(get_arch(name))
        shd = shardings_for(mesh, rules, logical,
                            {"m": sds, "v": sds, "step": torch.empty(())})
        ref_rules = ref.ShardingRules().filter_for_mesh(mesh)
        got, lg = _leaves(shd), _leaves(logical)
        shapes = _leaves({"m": sds, "v": sds, "step": torch.empty(())})
        assert got.keys() == lg.keys()
        for path, s in got.items():
            assert tuple(s.spec) == tuple(ref.logical_to_physical(
                ref_rules, lg[path], shapes[path].shape, mesh)), path
        assert tuple(got["step"].spec) == ()


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _FakeMesh({"pod": 2, "data": 4, "model": 2})
    assert NamedSharding(mesh, P(("pod", "data"), None, "model")
                         ).placements() == (Shard(0), Shard(0), Shard(2))
    assert NamedSharding(mesh, P(None, "data")).placements() == (
        Replicate(), Shard(1), Replicate())
    assert NamedSharding(mesh, P()).placements() == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        NamedSharding(mesh, P(("data", "pod"))).placements()


def test_mesh_state_is_thread_local():
    import threading

    from repro_torch.sharding import current_mesh, set_mesh

    mesh = _FakeMesh({"data": 2})
    set_mesh(mesh)
    seen = []
    t = threading.Thread(target=lambda: seen.append(current_mesh()))
    t.start()
    t.join()
    try:
        assert current_mesh() is mesh and seen == [None]
    finally:
        set_mesh(None)


def test_meshes_need_a_process_group_of_their_size():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for, make_production_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh_for(2, 2, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh_for(1, 1, 1)


def test_shard_constraint_without_a_mesh_is_the_input():
    from repro_torch.sharding import shard_constraint

    x = torch.ones(4, 4)
    assert shard_constraint(x, ShardingRules(), "fsdp", "tp") is x


# ------------------------------------------------------ 4 gloo CPU ranks
def _state(cfg):
    from repro_torch import models
    from repro_torch.train import init_opt_state

    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(params)
    g = torch.Generator().manual_seed(1)
    for tree in (opt["m"], opt["v"]):
        for k, t in _leaves(tree).items():
            t.copy_(torch.randn(t.shape, generator=g))
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    return {"params": params, "opt": opt}


def _ranks(rank, world, workdir):
    """reshard_state, restore(shardings=) and shard_constraint on this
    rank; returns what the parent checks, as plain tensors."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch.elastic import reshard_state
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import set_mesh, shard_constraint
    from repro_torch.sharding.specs import shardings_for
    from repro_torch.models.model import param_logical
    from repro_torch.train import opt_state_logical

    cfg = reduced(get_arch("smollm-135m"))
    state = _state(cfg)
    mesh, new = reshard_state(cfg, state, new_pods=2, data=2, model=1,
                              device="cpu")
    out = {"mesh": (tuple(mesh.mesh_dim_names), tuple(mesh.shape)),
           "step": new["opt"]["step"]}
    for part in ("params", "m", "v"):
        tree = new["params"] if part == "params" else new["opt"][part]
        for k, t in _leaves(tree).items():
            out[f"{part}.{k}"] = (t.full_tensor(), t.to_local().clone(),
                                  tuple(t.placements))

    # a checkpoint of the state, restored onto the mesh
    ckpt = CheckpointManager(f"{workdir}/ckpt")
    if rank == 0:
        ckpt.save_async(3, state)
        ckpt.wait()
    dist.barrier()
    logical = {"params": param_logical(cfg),
               "opt": opt_state_logical(param_logical(cfg))}
    shd = shardings_for(mesh, ShardingRules(), logical, state)
    tree, step, _ = ckpt.restore(state, shardings=shd)
    out["restored"] = {k: (t.full_tensor(), tuple(t.placements))
                       for k, t in _leaves(tree).items()}
    out["restored_step"] = step

    # shard_constraint: a DTensor is redistributed, a plain tensor is not
    x = torch.arange(64.0).reshape(8, 8)
    d = distribute_tensor(x, mesh, [Replicate()] * 3)
    set_mesh(mesh)
    try:
        c = shard_constraint(d, ShardingRules(), "fsdp", None)
        plain = shard_constraint(x, ShardingRules(), "fsdp", None)
    finally:
        set_mesh(None)
    out["constraint"] = (tuple(c.placements), c.full_tensor(),
                         c.to_local().clone(), plain is x)
    assert tuple(c.placements) == (Replicate(), Shard(0), Replicate())
    try:
        make_production_mesh(device="cpu")
        out["production"] = "built"
    except RuntimeError as e:
        out["production"] = str(e)
    return out


@pytest.fixture(scope="module", autouse=True)
def _four_ranks_started(tmp_path_factory):
    """The 4 ranks start with the module and run while the cases above
    do."""
    from repro_torch.launch.ranks import spawn_ranks

    tmp = tmp_path_factory.mktemp("reshard")
    out: list = []
    t = threading.Thread(target=lambda: out.extend(spawn_ranks(
        _ranks, 4, (str(tmp),), workdir=tmp)))
    t.start()
    yield t, out
    t.join()


@pytest.fixture(scope="module")
def four_ranks(_four_ranks_started):
    t, out = _four_ranks_started
    t.join()
    assert len(out) == 4, "the ranks failed"
    return out


def test_reshard_state_full_tensors_equal_the_input(four_ranks):
    state = _state(reduced(get_arch("smollm-135m")))
    want = {f"params.{k}": t for k, t in _leaves(state["params"]).items()}
    for part in ("m", "v"):
        want.update({f"{part}.{k}": t
                     for k, t in _leaves(state["opt"][part]).items()})
    for out in four_ranks:
        assert out["mesh"] == (("pod", "data", "model"), (2, 2, 1))
        assert torch.equal(out["step"], state["opt"]["step"])
        for k, t in want.items():
            full, _, _ = out[k]
            assert full.dtype == t.dtype and torch.equal(full, t), k


def test_reshard_state_shards_are_the_placements(four_ranks):
    """Rank r sits at mesh index (r // 2, r % 2, 0); its local shard of a
    leaf is the slice its placements name, and the specs are the
    reference's default rules on that mesh."""
    from repro_torch.models import abstract_params
    from repro_torch.models.params import leaves

    cfg = reduced(get_arch("smollm-135m"))
    mesh = _FakeMesh({"pod": 2, "data": 2, "model": 1})
    shd = dict(leaves(make_param_shardings(mesh, ShardingRules(),
                                           abstract_params(cfg))))
    sharded = 0
    for rank, out in enumerate(four_ranks):
        idx = (rank // 2, rank % 2, 0)
        for k, s in shd.items():
            full, local, placements = out[f"params.{k}"]
            assert placements == s.placements(), k
            want = full
            for axis, p in enumerate(placements):
                if p.is_shard():
                    n = mesh.devices.shape[axis]
                    want = want.chunk(n, dim=p.dim)[idx[axis]]
            sharded += local.numel() < full.numel()
            assert torch.equal(local, want), (rank, k)
    assert sharded > 0


def test_restore_with_shardings_places_the_checkpoint(four_ranks):
    state = _state(reduced(get_arch("smollm-135m")))
    want = _leaves(state)
    for out in four_ranks:
        assert out["restored_step"] == 3
        assert out["restored"].keys() == want.keys()
        for k, (full, _) in out["restored"].items():
            assert torch.equal(full, want[k]), k
        # each leaf on the placements reshard_state gave it
        for k, (_, placements) in out["restored"].items():
            part, _, leaf = k.partition(".")
            key = (f"params.{leaf}" if part == "params"
                   else leaf if leaf != "step" else None)
            if key is None:
                assert len(placements) == 3
            else:
                assert placements == out[key][2], k


def test_shard_constraint_redistributes_dtensors_only(four_ranks):
    x = torch.arange(64.0).reshape(8, 8)
    for rank, out in enumerate(four_ranks):
        placements, full, local, plain_is_input = out["constraint"]
        assert torch.equal(full, x) and plain_is_input
        assert torch.equal(local, x.chunk(2, dim=0)[rank % 2])
        assert "256 ranks" in out["production"]
