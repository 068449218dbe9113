"""The port's dry run (``launch/dryrun.py``) against the reference's.

  * every one of the 40 (arch, shape) pairs: ``params``,
    ``params_active``, ``status`` and ``skip_reason`` of ``run_cell``'s
    artifact (the step itself replaced by an empty recording: no step
    runs) equal the reference's ``count_params`` and ``applicable``;
  * smollm-135m decode_32k on the multi-pod mesh and train_4k on the
    single-pod mesh, run here and by the reference's CLI in subprocesses
    (its module sets ``XLA_FLAGS`` at import, so this process never
    imports it): ``mesh_shape``, ``argument_bytes`` and
    ``model_flops_total`` are equal (the multi-pod artifact has no
    roofline in either package: probes run on the single pod only);
  * a small train step counted on a one-rank (1, 1) mesh: its FLOPs equal
    ``FlopCounterMode``'s on the port's plain step exactly, and the
    matrix products' count written out below within 2%;
  * the ``podring`` variant's step on fake ("pod", "data", "model")
    meshes counts each gradient leaf's ring hops;
  * a meta tensor never reaches a kernel's ``LIBRARY.load()``; a CPU
    tensor still takes the plain version;
  * decode into caches whose sequence dim is sharded (long_500k's rules)
    on two gloo ranks equals plain decode, and ``shard_offset`` equals
    DTensor's own offsets.

The fake process groups start and end inside the dry run's calls.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_cases import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PAIRS = [(a, s) for a in ("llama-3.2-vision-11b", "mamba2-1.3b",
                          "mistral-large-123b", "mixtral-8x22b",
                          "nemotron-4-340b", "qwen2-7b", "qwen3-moe-30b-a3b",
                          "seamless-m4t-medium", "smollm-135m", "zamba2-7b")
         for s in ("decode_32k", "long_500k", "prefill_32k", "train_4k")]
CELLS = {("smollm-135m", "decode_32k", "multi"): False,
         ("smollm-135m", "train_4k", "single"): True}  # cell: has a roofline


def test_pairs_are_all_forty():
    from repro_torch.configs import ARCHS, SHAPES

    assert sorted(PAIRS) == sorted((a, s) for a in ARCHS for s in SHAPES)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_cell_header_equals_reference(monkeypatch, arch, shape):
    from repro import configs as ref_configs
    from repro.models.model import count_params as ref_count
    from repro_torch.launch import dryrun, hlo_stats

    monkeypatch.setattr(dryrun, "_lower_cell",
                        lambda *a, **k: hlo_stats.StepRecorder().close())
    art = dryrun.run_cell(arch, shape, "single", probes=False, device="cpu")
    cfg = ref_configs.get_arch(arch)
    runs, why = ref_configs.applicable(cfg, ref_configs.SHAPES[shape])
    assert art["params"] == ref_count(cfg)
    assert art["params_active"] == ref_count(cfg, active_only=True)
    assert art.get("status", "ok") == ("ok" if runs else "skipped")
    assert art.get("skip_reason") == (why if not runs else None)
    if runs:
        assert art["mesh_shape"] == {"data": 16, "model": 16}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """{cell: (port artifact, reference artifact)}: the reference's CLI
    runs in subprocesses while the port counts here."""
    from repro_torch.launch import dryrun

    out = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", cell[0],
         "--shape", cell[1], "--mesh", cell[2], "--force", "--out",
         str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for cell in CELLS}
    port = {cell: dryrun.run_cell(*cell, probes=roof, device="cpu")
            for cell, roof in CELLS.items()}
    got = {}
    for cell, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        ref = json.loads(dryrun.cell_path(out, *cell).read_text())
        got[cell] = (port[cell], ref)
    return got


@pytest.mark.parametrize("cell", sorted(CELLS), ids="__".join)
def test_cell_matches_reference(cells, cell):
    port, ref = cells[cell]
    assert ref["status"] == "ok"
    for key in ("params", "params_active", "mesh_shape", "overrides"):
        assert port[key] == ref[key], key
    assert port["full"]["argument_bytes"] == ref["full"]["argument_bytes"]
    assert port["full"]["flops_per_device"] > 0
    assert port["full"]["code_bytes"] == 0
    assert set(port["full"]) == set(ref["full"])
    if CELLS[cell]:
        assert set(port["roofline"]) == set(ref["roofline"])
        assert port["roofline"]["model_flops_total"] == \
            ref["roofline"]["model_flops_total"]
        assert port["roofline"]["probe_groups"] is None
        assert port["roofline"]["hlo_flops_total"] == \
            port["full"]["flops_per_device"] * 256
    else:
        assert "roofline" not in port and "roofline" not in ref


def test_multi_pod_decode_counts_its_collectives(cells):
    full = cells["smollm-135m", "decode_32k", "multi"][0]["full"]
    c = full["collectives"]
    assert c["counts"]["all-gather"] > 0
    assert full["wire_bytes_per_device"] == c["wire_bytes"] > 0
    assert full["temp_bytes"] > 0 and full["alias_bytes"] > 0


# ------------------------------------------------------ one rank, counted
B, S = 2, 32


def _small_cfg():
    from repro_torch.configs import ARCHS, reduced

    return dataclasses.replace(reduced(ARCHS["smollm-135m"]),
                               dtype="float32", loss_chunk=16)


def _analytic_flops(cfg) -> int:
    """The matrix products of one training step without remat: forward
    F = per layer the q, k, v, o and the three gated-FFN projections plus
    the scores and the weighted sum over all S x S pairs, and the logits
    over the tied vocabulary; backward 2F (the gradient of each operand)."""
    t, d, hd = B * S, cfg.d_model, cfg.head_dim
    h, kv, f, v = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size
    layer = (2 * t * d * h * hd + 2 * 2 * t * d * kv * hd
             + 2 * t * h * hd * d + 3 * 2 * t * d * f
             + 2 * 2 * B * h * S * S * hd)
    fwd = cfg.num_layers * layer + 2 * t * d * v
    return 3 * fwd


def test_one_rank_count_equals_flop_counter_on_the_plain_step():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import models
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.sharding.specs import ShardingRules
    from repro_torch.train import OptConfig, init_opt_state, make_train_step

    cfg = _small_cfg()
    assert not cfg.remat and not cfg.use_pallas
    counted = dryrun.count_step(cfg, ShapeSpec("small", S, B, "train"),
                                (1, 1), device="cpu")
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (B, S),
                                          dtype=np.int32))
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, ShardingRules(batch=None, fsdp=None,
                                              tp=None), OptConfig())
    opt = init_opt_state(params)
    with FlopCounterMode(display=False) as fcm:
        step(params, opt, batch)
    assert counted["flops_per_device"] == fcm.get_total_flops()
    want = _analytic_flops(cfg)
    assert abs(counted["flops_per_device"] - want) <= 0.02 * want
    # f32 masters, both moments, the step count, the batch; nothing
    # collective on one rank
    n = models.count_params(cfg)
    assert counted["argument_bytes"] == 3 * 4 * n + 4 + 2 * 4 * B * S
    assert counted["collectives"]["wire_bytes"] == 0


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (3, 2, 1)])
def test_podring_step_counts_its_ring_hops(mesh_shape):
    """The ``podring`` variant's step on inner-sharded DTensors on a fake
    ("pod", "data", "model") mesh, int8 on the wire: each gradient leaf's
    local shard goes round the ring once (the 2-pod pairwise exchange is
    one hop, n pods take n - 1 hops of reduce-scatter and n - 1 of
    all-gather), each hop a collective-permute of the int8 values and one
    of their scales."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models.model import abstract_params
    from repro_torch.tree import tree_leaves

    cfg = reduced(ARCHS["smollm-135m"])
    shape = ShapeSpec("train", 16, 12, "train")
    counted = dryrun.count_step(cfg, shape, mesh_shape, podring=True,
                                device="cpu")
    n = mesh_shape[0]
    hops = 1 if n == 2 else 2 * (n - 1)
    leaves = len(tree_leaves(abstract_params(cfg)))
    coll = counted["collectives"]["counts"]
    assert coll["collective-permute"] == leaves * hops * 2
    assert counted["flops_per_device"] > 0


# ------------------------------------------------------ the meta routes
def test_meta_tensors_never_reach_a_kernel_library(monkeypatch):
    from repro_torch.kernels.quantize import ops, ref
    from repro_torch.launch import hlo_stats

    def refuse():
        raise AssertionError("a kernel library was loaded")

    monkeypatch.setattr(ops.LIBRARY, "load", refuse)
    x = torch.empty(6, 333, device="meta")
    with hlo_stats.StepRecorder() as rec:
        q, s = ops.quantize_int8(x)
        back = ops.dequantize_int8(q, s)
    assert q.is_meta and q.shape == x.shape and q.dtype == torch.int8
    assert s.is_meta and s.shape == (8,) and s.dtype == torch.float32
    assert back.is_meta and back.shape == x.shape
    assert back.dtype == torch.float32
    # each kernel reads its inputs and writes its outputs once
    n = 6 * 333
    assert rec.bytes == (4 * n + n + 4 * 8) + (n + 4 * 8 + 4 * n)
    assert rec.flops == 0

    g = torch.Generator().manual_seed(1)
    x = torch.randn(6, 333, generator=g)
    q, s = ops.quantize_int8(x)
    q_ref, s_ref = ref.quantize_int8_flat(x.reshape(-1), 256)
    assert torch.equal(q.reshape(-1), q_ref) and torch.equal(s, s_ref)
    assert torch.equal(ops.dequantize_int8(q, s).reshape(-1),
                       ref.dequantize_int8_flat(q_ref, s_ref, 256))


# --------------------------------------- long_500k's rules on two ranks
# context parallelism: the KV caches' sequence dim sharded over "data"
CP_ARCHS = ("qwen2-7b", "zamba2-7b")
CP_B, CP_PROMPT, CP_DECODE, CP_TMAX = 2, 18, 4, 40  # slots 18-21 cross 20


def _cp_cfg(arch: str):
    from repro_torch.configs import ARCHS, reduced

    return dataclasses.replace(reduced(ARCHS[arch], vocab_size=256),
                               dtype="float32")


def _cp_ranks(rank, world, states, tokens):
    """Each arch's decode from a plain prefill, CP_DECODE steps, with the
    parameters and caches placed by the dry run's long_500k rules on a
    ("data", "model") = (2, 1) mesh, then on plain tensors: every step's
    logits and the caches after (numpy, whole)."""
    from repro_torch import convert
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.launch.inputs import decode_logical
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.model import abstract_params
    from repro_torch.sharding.specs import (device_put, is_dtensor,
                                            make_param_shardings, set_mesh,
                                            shardings_for)
    from repro_torch.tree import tree_leaves, tree_map

    mesh = make_mesh_for(1, 2, 1, device="cpu")
    rules = rules_for(SHAPES["long_500k"])
    set_mesh(mesh)

    def full(t):
        return (t.full_tensor() if is_dtensor(t) else t).numpy()

    out = {}
    for arch in CP_ARCHS:
        cfg = _cp_cfg(arch)
        for sharded in (True, False):
            params = convert.params_from_state(states[arch], "cpu")
            state, _ = prefill(cfg, rules, params, {"tokens": torch.tensor(
                tokens[:, :CP_PROMPT])}, t_max=CP_TMAX)
            place = lambda tree, logical: tree  # noqa: E731
            if sharded:
                params = device_put(params, make_param_shardings(
                    mesh, rules, abstract_params(cfg)))

                def place(tree, logical):
                    return device_put(tree, shardings_for(mesh, rules,
                                                          logical, tree))

                state = place(state, decode_logical(cfg))
                # [layers..., B, T, Kv, Dh]: T cut over "data"
                seq_cut = sum(f"Shard(dim={t.ndim - 3})" in str(t.placements)
                              for t in tree_leaves(state["kv"]))
            logits = []
            for i in range(CP_DECODE):
                tok = torch.tensor(tokens[:, CP_PROMPT + i:CP_PROMPT + i + 1])
                lg, state = decode_step(cfg, rules, params, state,
                                        place(tok, ("batch", None)))
                logits.append(full(lg))
            out[arch, sharded] = {"logits": np.stack(logits),
                                  "state": tree_map(full, state)}
        out[arch, "seq_cut"] = seq_cut
    out["encdec"] = _encdec_losses(mesh)
    out["offsets"] = _shard_offsets(mesh)
    set_mesh(None)
    return out


def _shard_offsets(mesh) -> list:
    """``shard_offset`` of this rank's shard against DTensor's own, along
    dims cut evenly, unevenly, or into an empty last piece."""
    import torch.distributed.tensor as dt
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from repro_torch.sharding.specs import shard_offset

    out = []
    for shape, dim in (((2, 40, 3), 1), ((2, 41, 3), 1), ((1, 1, 3), 1),
                       ((5, 2), 0), ((3, 7), -1)):
        pls = [dt.Shard(dim % len(shape)), dt.Replicate()]
        _, want = compute_local_shape_and_global_offset(shape, mesh, pls)
        x = dt.empty(shape, device_mesh=mesh, placements=pls)
        out.append((shard_offset(x, dim), want[dim % len(shape)]))
    return out


def _encdec_losses(mesh) -> dict:
    """The reduced encoder-decoder's loss with DTensor parameters and batch
    (the train cells' rules) and on plain tensors: the encoder's positions
    must join the DTensor frames."""
    from repro_torch import models
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.launch.inputs import train_batch_logical
    from repro_torch.models.model import abstract_params
    from repro_torch.sharding.specs import (device_put, make_param_shardings,
                                            shardings_for)

    cfg = _cp_cfg("seamless-m4t-medium")
    rules = rules_for(SHAPES["train_4k"])
    g = torch.Generator().manual_seed(5)
    params = models.init_params(cfg, g, "cpu")
    batch = {"tokens": torch.randint(0, 256, (CP_B, 16), generator=g,
                                     dtype=torch.int32),
             "frames": torch.randn(CP_B, cfg.num_frames, cfg.d_model,
                                   generator=g)}
    batch["labels"] = batch["tokens"]
    sharded = models.loss_fn(cfg, rules, device_put(
        params, make_param_shardings(mesh, rules, abstract_params(cfg))),
        device_put(batch, shardings_for(mesh, rules, train_batch_logical(cfg),
                                        batch)))[0]
    return {"sharded": float(sharded.full_tensor()),
            "plain": float(models.loss_fn(cfg, rules, params, batch)[0])}


@pytest.fixture(scope="module")
def context_parallel(tmp_path_factory):
    from repro_torch import convert, models
    from repro_torch.launch.ranks import spawn_ranks

    states = {a: convert.params_state(models.init_params(
        _cp_cfg(a), torch.Generator().manual_seed(i), "cpu"))
        for i, a in enumerate(CP_ARCHS)}
    tokens = np.random.default_rng(3).integers(
        0, 256, (CP_B, CP_PROMPT + CP_DECODE), dtype=np.int32)
    return spawn_ranks(_cp_ranks, 2, (states, tokens),
                       workdir=tmp_path_factory.mktemp("cp"))


@pytest.mark.parametrize("arch", CP_ARCHS)
def test_decode_on_sequence_sharded_caches_equals_plain(context_parallel,
                                                        arch):
    """The dry run's long_500k rules shard every KV cache's sequence dim;
    each decode step writes its slot on the rank that holds it (slots 18
    and 19 on rank 0, 20 and 21 on rank 1) and attends over both halves:
    logits and caches equal the plain decode's (f32, 1e-5)."""
    from repro_torch.tree import leaves

    for out in context_parallel:
        got, want = out[arch, True], out[arch, False]
        assert out[arch, "seq_cut"] > 0
        scale = np.abs(want["logits"]).max()
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                                   atol=1e-5 * scale)
        for (k, a), (_, b) in zip(leaves(got["state"]),
                                  leaves(want["state"]), strict=True):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(
                np.abs(b).max(), 1e-30), err_msg=k)


def test_shard_offset_is_dtensors_own(context_parallel):
    for out in context_parallel:
        got, want = zip(*out["offsets"])
        assert got == want
    assert any(g for out in context_parallel for g, _ in out["offsets"])


def test_encoder_runs_on_dtensors(context_parallel):
    for out in context_parallel:
        got = out["encdec"]
        assert got["sharded"] == pytest.approx(got["plain"], rel=1e-5)


# ------------------------------------ what the card's torch refuses
def _refuse_strided_views(monkeypatch):
    """Make DTensor's view rule raise where it would flatten a dim sharded
    behind another into a ``_StridedShard``, as the card's torch 2.11
    refuses such a view outright."""
    import torch.distributed.tensor._ops._view_ops as view_ops
    from torch.distributed.tensor.placement_types import _StridedShard

    rule = view_ops.propagate_shape_and_sharding

    def walk(x):
        if isinstance(x, _StridedShard):
            raise RuntimeError("a view flattens a dim sharded behind another")
        if isinstance(x, (list, tuple)):
            for y in x:
                walk(y)

    def refusing(*args, **kwargs):
        out = rule(*args, **kwargs)
        walk(out)
        return out

    monkeypatch.setattr(view_ops, "propagate_shape_and_sharding", refusing)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_ssm_step_takes_no_strided_view(monkeypatch, kind):
    """Reduced mamba2 on a fake ("data", "model") = (2, 2) mesh, the train
    cells' rules: the batch cut over "data", the heads over "model". The
    SSD scan and the SSM projections run on local shards, so the step
    flattens no dim sharded behind another."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun

    _refuse_strided_views(monkeypatch)
    cfg = reduced(ARCHS["mamba2-1.3b"])
    counted = dryrun.count_step(cfg, ShapeSpec(kind, 32, 8, kind),
                                (2, 2), device="cpu")
    assert counted["flops_per_device"] > 0
