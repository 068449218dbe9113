"""The port's model stack on DTensor parameters against the reference's
GSPMD-sharded steps.

Four gloo CPU ranks (one spawn for the file) build the (2, 2) ("data",
"model") mesh with ``make_mesh_for(1, 2, 2)`` and the reference's test
rules, ``ShardingRules(batch=("data",), fsdp="data", tp="model")``. For
reduced qwen2-7b, qwen3-moe-30b-a3b (also with ``moe_shard_dispatch``)
and mamba2-1.3b at vocab 256 and B 4 x S 32, each rank places the same
parameters with ``device_put(params, make_param_shardings(...))`` and the
batch by ``train_batch_logical``, and runs ``make_train_step``:

  (i)   bf16, against the reference's single-device jitted step at the
        reference's own tolerances (``tests/test_distributed.py:88-92``);
  (ii)  f32, against the reference's sharded step on the same mesh (loss
        and gradient norm 1e-4, every gradient leaf 1e-4 of the leaf's
        largest entry, parameters within AdamW's step bound,
        ``chip_smoke.TRAIN_CPU_TOL``) and against the port's own step on
        plain tensors under the same mesh (loss and every gradient leaf
        1e-5 of the leaf's largest entry, parameters 1e-5);
  (iii) every rank's local shard of every parameter is the slice of the
        global tensor that ``make_param_shardings`` names, and the AdamW
        moments sit on the parameters' placements;
  (iv)  sharded prefill and 3 decode steps, the caches placed by
        ``decode_logical``, against the port on plain tensors (1e-5) and
        the reference (1e-4), f32, for qwen2 and mamba2; a flash-kernel
        prefill and the forward through the flash or SSD kernel
        (``use_pallas``, their plain versions here) across the kernels'
        local boundaries, and ``make_serve_step`` under the mesh;
  (v)   a kernel wrapper handed a DTensor raises, ``compress`` of a
        DTensor equals the whole tensor's bit for bit, and the compressed
        step under the mesh stays within a quantization step (gradients)
        and AdamW's bound (parameters) of the compressed step on plain
        tensors.

The reference runs once, in a subprocess with 4 host devices, while the
ranks run; the ranks import this file, which imports no jax.
"""

from __future__ import annotations

import dataclasses
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_cases import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import TRAIN_CPU_TOL  # noqa: E402

CASES = {
    "qwen2": ("qwen2-7b", {}),
    "moe": ("qwen3-moe-30b-a3b", {}),
    "moe_shard": ("qwen3-moe-30b-a3b", {"moe_shard_dispatch": True}),
    "mamba2": ("mamba2-1.3b", {}),
}
BF16_CASES = ("qwen2", "moe", "mamba2")
SERVE_CASES = ("qwen2", "mamba2")
VOCAB, B, S, DECODE, T_MAX = 256, 4, 32, 3, 40
MESH = {"data": 2, "model": 2}
WORLD = 4
REF_TOL = {"loss": 5e-3, "atol": 5e-3, "rtol": 1e-2}  # test_distributed.py
F32_TOL = 1e-5


def _tcfg(case: str, dtype: str, **kw):
    from repro_torch.configs import ARCHS, reduced

    arch, extra = CASES[case]
    return dataclasses.replace(reduced(ARCHS[arch], vocab_size=VOCAB),
                               dtype=dtype, **extra, **kw)


def _rules():
    from repro_torch.sharding.specs import ShardingRules

    return ShardingRules(batch=("data",), fsdp="data", tp="model")


def _inputs() -> dict:
    """Seeded parameters (numpy, by dotted path), batches and decode
    tokens, shared by the ranks and the reference."""
    from repro_torch import convert
    from repro_torch.models import init_params

    rng = np.random.default_rng(0)
    states = {}
    for i, case in enumerate(CASES):
        g = torch.Generator().manual_seed(i)
        states[case] = convert.params_state(
            init_params(_tcfg(case, "float32"), g, "cpu"))
    return {
        "states": states,
        "batch": {k: rng.integers(0, VOCAB, (B, S), dtype=np.int32)
                  for k in ("tokens", "labels")},
        "decode": rng.integers(0, VOCAB, (DECODE, B, 1), dtype=np.int32),
    }


# ------------------------------------------------------------ the ranks
def _full(t):
    from repro_torch.sharding.specs import is_dtensor

    return t.full_tensor() if is_dtensor(t) else t


def _numpy(tree) -> dict:
    from repro_torch import convert
    from repro_torch.tree import tree_map

    return convert.params_state(tree_map(_full, tree))


def _recorder(box: dict, transform=None):
    """A grad_transform that keeps the gradients it hands on."""
    def hook(grads):
        if transform is not None:
            from repro_torch.tree import tree_map

            grads = tree_map(transform, grads)
        box["grads"] = grads
        return grads

    return hook


def _train(cfg, params, batch, transform=None) -> dict:
    """One AdamW step: loss, gradient norm, the gradients handed to AdamW
    and the parameters after it (numpy), plus the trees themselves."""
    from repro_torch.train import OptConfig, init_opt_state, make_train_step

    box: dict = {}
    opt = init_opt_state(params)
    step = make_train_step(cfg, _rules(), OptConfig(),
                           grad_transform=_recorder(box, transform))
    params, opt, m = step(params, opt, batch)
    return {"loss": float(_full(m["loss"])),
            "grad_norm": float(_full(m["grad_norm"])),
            "grads": _numpy(box["grads"]), "params": _numpy(params),
            "trees": (params, opt)}


def _serve(cfg, params, batch, decode, place) -> dict:
    """Prefill, DECODE steps on the given tokens, then one greedy
    ``make_serve_step``: every step's logits and the greedy tokens."""
    from repro_torch.launch.inputs import decode_logical
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.serve_step import make_serve_step

    rules = _rules()
    state, logits = prefill(cfg, rules, params, batch, t_max=T_MAX)
    state = place(state, decode_logical(cfg))
    out = [_full(logits).numpy()]
    for tok in decode:
        tok = place({"t": torch.tensor(tok)}, {"t": ("batch", None)})["t"]
        logits, state = decode_step(cfg, rules, params, state, tok)
        out.append(_full(logits).numpy())
    nxt, _ = make_serve_step(cfg, rules)(params, state, tok)
    return {"logits": np.stack(out), "greedy": _full(nxt).numpy()}


def _guards(mesh) -> dict:
    """Which kernel wrappers refuse a DTensor, and compress of DTensors
    against compress of the whole tensors."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.quantize.ops import (dequantize_int8,
                                                  quantize_int8)
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.waterfill.ops import (segment_sum_ordered,
                                                   waterfill_rates)
    from repro_torch.transfer.compression import compress

    g = torch.Generator().manual_seed(7)

    def dt(*shape, place=(Shard(0), Replicate())):
        return distribute_tensor(torch.randn(*shape, generator=g), mesh,
                                 list(place))

    q = dt(2, 8, 4, 16)
    calls = {
        "flash_attention": lambda: flash_attention(q, q, q),
        "ssd_scan": lambda: ssd_scan(q, dt(2, 8, 4), dt(4), dt(2, 8, 16),
                                     dt(2, 8, 16), chunk=4),
        "quantize_int8": lambda: quantize_int8(dt(6, 333)),
        "dequantize_int8": lambda: dequantize_int8(
            dt(4, 256).to(torch.int8), dt(4, place=(Replicate(),) * 2)),
        "waterfill_rates": lambda: waterfill_rates(
            *(dt(8).double() for _ in range(5))),
        "segment_sum_ordered": lambda: segment_sum_ordered(
            dt(8).double(), dt(8).long(), 2),
    }
    raised = {}
    for name, call in calls.items():
        try:
            call()
            raised[name] = False
        except TypeError as e:
            raised[name] = "DTensor" in str(e)
    gaps = {}
    for shape, place in (((6, 333), (Shard(0), Shard(1))),
                         ((1000,), (Shard(0), Replicate())),
                         ((3, 4, 300), (Replicate(), Shard(2)))):
        x = dt(*shape, place=place)
        for pallas in (False, True):
            got = compress(x, use_pallas=pallas)
            same_place = tuple(got.placements) == tuple(x.placements)
            want = compress(x.full_tensor(), use_pallas=pallas)
            gaps[shape, pallas] = (same_place,
                                   bool(torch.equal(got.full_tensor(), want)))
    return {"raised": raised, "compress": gaps}


def _ranks(rank, world, inp):
    from repro_torch import convert
    from repro_torch.launch.inputs import train_batch_logical
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import forward
    from repro_torch.models.model import abstract_params
    from repro_torch.sharding.specs import (device_put, make_param_shardings,
                                            set_mesh, shardings_for)
    from repro_torch.transfer.compression import compress
    from repro_torch.tree import leaves, tree_leaves

    mesh = make_mesh_for(1, MESH["data"], MESH["model"], device="cpu")
    rules = _rules()
    set_mesh(mesh)

    def place(tree, logical):
        return device_put(tree, shardings_for(mesh, rules, logical, tree))

    out: dict = {"rank": rank, "coords": mesh.get_coordinate()}
    try:
        batch = convert.batch_from_numpy(inp["batch"], "cpu")
        for case in CASES:
            dtypes = ("bfloat16",) * (case in BF16_CASES) + ("float32",)
            for dtype in dtypes:
                cfg = _tcfg(case, dtype)
                pshard = make_param_shardings(mesh, rules,
                                              abstract_params(cfg))

                def params(sharded=True):
                    p = convert.params_from_state(inp["states"][case], "cpu")
                    return device_put(p, pshard) if sharded else p

                bs = place(batch, train_batch_logical(cfg))
                rec = _train(cfg, params(), bs)
                ps, opt = rec.pop("trees")
                if dtype == "float32":
                    rec["local"] = {
                        k: (tuple(map(str, v.placements)),
                            tuple(map(str, sh.placements())),
                            v.to_local().numpy())
                        for (k, v), sh in zip(leaves(ps),
                                              tree_leaves(pshard))}
                    rec["moments"] = all(
                        m.placements == p.placements
                        for p, m in zip(tree_leaves(ps) * 2,
                                        tree_leaves(opt["m"])
                                        + tree_leaves(opt["v"])))
                    plain = _train(cfg, params(False), batch)
                    plain.pop("trees")
                    rec["plain"] = plain
                if case in SERVE_CASES and dtype == "float32":
                    rec["serve"] = _serve(cfg, params(), bs, inp["decode"],
                                          place)
                    rec["serve_plain"] = _serve(cfg, params(False), batch,
                                                inp["decode"],
                                                lambda t, _: t)
                    pal = dataclasses.replace(cfg, use_pallas=True)
                    if case == "qwen2":
                        rec["serve_flash"] = _serve(pal, params(), bs,
                                                    inp["decode"], place)
                    with torch.no_grad():  # the kernels have no backward
                        rec["forward_kernels"] = _full(
                            forward(pal, rules, params(), bs)).numpy()
                        rec["forward_plain"] = forward(
                            cfg, rules, params(False), batch).numpy()
                if case == "qwen2" and dtype == "float32":
                    comp = _train(cfg, params(), bs, compress)
                    comp.pop("trees")
                    comp_plain = _train(cfg, params(False), batch, compress)
                    comp_plain.pop("trees")
                    rec["compressed"] = (comp, comp_plain)
                if rank != 0:  # rank 0 alone returns the global values
                    for key in ("params", "grads", "plain", "serve",
                                "serve_plain", "serve_flash", "compressed",
                                "forward_kernels", "forward_plain"):
                        rec.pop(key, None)
                out[case, dtype] = rec
        out["guards"] = _guards(mesh)
    finally:
        set_mesh(None)
    return out


# -------------------------------------------------------- the reference
REFERENCE = """
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ARCHS, reduced
from repro.launch.mesh import make_mesh_for
from repro.models import decode_step, loss_fn, prefill
from repro.models.model import abstract_params
from repro.sharding.specs import ShardingRules, make_param_shardings, set_mesh
from repro.train import OptConfig, init_opt_state, make_train_step
from repro_torch.convert import params_state

inp, cases, bf16, serve, (vocab, t_max) = pickle.load(open(sys.argv[1], "rb"))

def tree(state):
    out = {}
    for key, a in state.items():
        *path, leaf = key.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return out

def step(cfg, rules, params, batch, grads=False):
    out = {}
    if grads:  # the gradients the step hands AdamW (f32: no cast)
        out["grads"] = params_state(jax.jit(jax.grad(
            lambda p: loss_fn(cfg, rules, p, batch)[0]))(params))
    p, _, m = jax.jit(make_train_step(cfg, rules, OptConfig()))(
        params, init_opt_state(params), batch)
    out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               params=params_state(p))
    return out

rules0 = ShardingRules(batch=None, fsdp=None, tp=None)
rules = ShardingRules(batch=("data",), fsdp="data", tp="model")
mesh = make_mesh_for(1, 2, 2)
batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
out = {}
for case, (arch, extra) in cases.items():
    cfg = reduced(ARCHS[arch], vocab_size=vocab, **extra)
    if case in bf16:
        out[case, "bfloat16"] = step(dataclasses.replace(cfg, dtype="bfloat16"),
                                     rules0, tree(inp["states"][case]), batch)
    f32 = dataclasses.replace(cfg, dtype="float32")
    set_mesh(mesh)
    pshard = make_param_shardings(mesh, rules, abstract_params(f32))
    params = jax.device_put(tree(inp["states"][case]), pshard)
    with mesh:
        out[case, "float32"] = step(f32, rules, params, batch, grads=True)
    set_mesh(None)
    if case in serve:
        params = tree(inp["states"][case])
        state, logits = jax.jit(lambda p, b: prefill(f32, rules0, p, b,
                                                     t_max=t_max))(
            params, {"tokens": batch["tokens"]})
        dec = jax.jit(lambda p, s, t: decode_step(f32, rules0, p, s, t))
        logs = [np.asarray(logits)]
        for tok in inp["decode"]:
            logits, state = dec(params, state, jnp.asarray(tok))
            logs.append(np.asarray(logits))
        out[case, "serve"] = np.stack(logs)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's results, "ranks": each rank's}: the ranks
    run while the reference's subprocess does."""
    from repro_torch.launch.ranks import spawn_ranks

    tmp = tmp_path_factory.mktemp("sharded")
    inp = _inputs()
    src, dst = tmp / "ref_in.pkl", tmp / "ref_out.pkl"
    with open(src, "wb") as f:
        pickle.dump((inp, CASES, BF16_CASES, SERVE_CASES, (VOCAB, T_MAX)), f)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(src), str(dst)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = spawn_ranks(_ranks, WORLD, (inp,), workdir=tmp)
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    with open(dst, "rb") as f:
        return {"inp": inp, "ref": pickle.load(f), "ranks": ranks}


def _rel_gap(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max(initial=0.0)
                 / max(np.abs(b).max(initial=0.0), 1e-30))


def _lr_sum() -> float:
    from repro_torch.train import OptConfig
    from repro_torch.train.optimizer import schedule

    return float(schedule(OptConfig(), torch.tensor(1)))


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_sharded_step_matches_the_reference_single_device_step(
        runs, case):
    got = runs["ranks"][0][case, "bfloat16"]
    want = runs["ref"][case, "bfloat16"]
    assert abs(got["loss"] - want["loss"]) < REF_TOL["loss"]
    assert sorted(got["params"]) == sorted(want["params"])
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, atol=REF_TOL["atol"],
                                   rtol=REF_TOL["rtol"], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_f32_sharded_step_matches_the_reference_sharded_step(runs, case):
    got = runs["ranks"][0][case, "float32"]
    want = runs["ref"][case, "float32"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, g in want["grads"].items():
        assert _rel_gap(got["grads"][k], g) <= 1e-4, (k, _rel_gap(
            got["grads"][k], g))
    allowed = TRAIN_CPU_TOL["adam_steps"] * _lr_sum()
    for k, w in want["params"].items():
        gap = float(np.abs(got["params"][k] - w).max(initial=0.0))
        assert gap <= allowed, (k, gap, allowed)


@pytest.mark.parametrize("case", list(CASES))
def test_f32_sharded_step_matches_the_plain_step(runs, case):
    got = runs["ranks"][0][case, "float32"]
    plain = got["plain"]
    np.testing.assert_allclose(got["loss"], plain["loss"], rtol=F32_TOL)
    assert sorted(got["grads"]) == sorted(plain["grads"])
    for k, g in plain["grads"].items():
        assert _rel_gap(got["grads"][k], g) <= F32_TOL, k
        np.testing.assert_allclose(got["params"][k], plain["params"][k],
                                   rtol=0, atol=F32_TOL, err_msg=k)
    moved = max(float(np.abs(plain["params"][k]
                             - runs["inp"]["states"][case][k]).max())
                for k in plain["params"])
    assert moved > 0  # the step moved the parameters


@pytest.mark.parametrize("case", list(CASES))
def test_local_shards_are_where_the_param_shardings_say(runs, case):
    """Each rank's local shard is the slice of rank 0's global parameter
    that its mesh coordinate and the spec's mesh axes name; the moments
    share the parameters' placements."""
    from repro_torch.models.model import abstract_params
    from repro_torch.sharding.specs import make_param_shardings
    from repro_torch.tree import leaves

    class _Mesh:  # the (2, 2) mesh's axis names and shape, no ranks
        axis_names = tuple(MESH)
        devices = np.empty(tuple(MESH.values()))

    specs = dict(leaves(make_param_shardings(
        _Mesh(), _rules(), abstract_params(_tcfg(case, "float32")))))
    full = runs["ranks"][0][case, "float32"]["params"]
    names = list(MESH)
    sharded_leaves = 0
    for out in runs["ranks"]:
        rec = out[case, "float32"]
        assert rec["moments"]
        coord = dict(zip(names, out["coords"]))
        assert sorted(rec["local"]) == sorted(specs)
        for k, (placed, wanted, local) in rec["local"].items():
            assert placed == wanted, k
            idx = []
            for d, entry in enumerate(specs[k].spec):
                axes = () if entry is None else (
                    entry if isinstance(entry, tuple) else (entry,))
                n, i = 1, 0
                for a in axes:
                    n, i = n * MESH[a], i * MESH[a] + coord[a]
                size = full[k].shape[d] // n
                idx.append(slice(i * size, (i + 1) * size))
            sharded_leaves += any(e is not None for e in specs[k].spec)
            np.testing.assert_array_equal(local, full[k][tuple(idx)],
                                          err_msg=k)
    assert sharded_leaves > 0


@pytest.mark.parametrize("case", SERVE_CASES)
def test_sharded_prefill_and_decode_match(runs, case):
    rec = runs["ranks"][0][case, "float32"]
    got, plain = rec["serve"], rec["serve_plain"]
    np.testing.assert_allclose(got["logits"], plain["logits"], rtol=0,
                               atol=F32_TOL)
    np.testing.assert_allclose(got["logits"], runs["ref"][case, "serve"],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["greedy"], plain["greedy"])
    if case == "qwen2":
        np.testing.assert_allclose(rec["serve_flash"]["logits"],
                                   plain["logits"], rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("case", SERVE_CASES)
def test_kernel_forward_under_the_mesh_matches(runs, case):
    """``forward`` with ``use_pallas`` under the mesh: the flash (qwen2)
    or SSD (mamba2) kernel's wrapper handed local shards, here its plain
    version, against the plain forward without the kernels (the
    reference's own Pallas-against-jnp tolerance, 1e-4)."""
    rec = runs["ranks"][0][case, "float32"]
    np.testing.assert_allclose(rec["forward_kernels"], rec["forward_plain"],
                               rtol=1e-4, atol=1e-4)


def test_decode_caches_follow_the_ssm_cache_logical():
    from repro_torch.launch.inputs import decode_logical
    from repro_torch.models.ssm import ssm_cache_logical

    assert decode_logical(_tcfg("mamba2", "float32"))["ssm"] == \
        ssm_cache_logical()


def test_kernel_wrappers_refuse_a_dtensor(runs):
    for out in runs["ranks"]:
        assert out["guards"]["raised"] == dict.fromkeys(
            out["guards"]["raised"], True)
        assert len(out["guards"]["raised"]) == 6


def test_compress_of_a_dtensor_equals_the_whole_tensors(runs):
    for out in runs["ranks"]:
        for key, (same_place, equal) in out["guards"]["compress"].items():
            assert same_place and equal, key


def test_compressed_sharded_step_matches_the_plain_compressed_step(runs):
    comp, plain = runs["ranks"][0]["qwen2", "float32"]["compressed"]
    np.testing.assert_allclose(comp["loss"], plain["loss"], rtol=F32_TOL)
    allowed = TRAIN_CPU_TOL["adam_steps"] * _lr_sum()
    raw = runs["ranks"][0]["qwen2", "float32"]["plain"]["grads"]
    for k, g in plain["grads"].items():
        step = np.abs(raw[k]).max(initial=0.0) / 127  # a quantization step
        assert np.abs(comp["grads"][k] - g).max(initial=0.0) <= step, k
        assert np.abs(comp["params"][k] - plain["params"][k]).max(
            initial=0.0) <= allowed, k
    assert any(not np.array_equal(g, raw[k])
               for k, g in plain["grads"].items())  # the hook compressed
