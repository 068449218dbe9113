"""The port's training path against the reference package's, on the CPU.

JAX parameters (``repro.models.init_params``) are carried across leaf for
leaf (``repro_torch.convert``), and both packages run the same numpy
batches in f32 at ``reduced(...)`` size with ``use_pallas=False``, as the
reference's training driver runs:

- ``loss_fn`` and its gradients (autograd against ``jax.grad``) for
  reduced smollm-135m, zamba2-7b and mamba2-1.3b under every remat
  policy, 1e-4 of each leaf's largest gradient (measured ~1e-5: the two
  frameworks sum in other orders);
- ``adamw_update`` over 10 steps, 1e-6;
- ``make_train_step`` over 3 steps against the jitted JAX step at the
  default learning rate (3e-4): losses within 1e-4, parameters within
  1e-4 of each leaf's largest value, with and without microbatches; with
  the int8-compression hook the compressed gradients are bit for bit
  those of the reference's plain compressor on the same gradients, and
  the 3-step trajectory is within 1e-3 of the reference run with its
  Pallas hook. AdamW's step m/sqrt(v) is about +-lr per entry whatever
  the gradient's size, so float-order noise on near-zero gradient
  entries moves a parameter by up to ~lr, and an int8 rounding flip moves
  its gradient by a whole quantization step: the parameter gaps scale
  with lr (measured 5.0e-5 without and 3.1e-4 with the hook at lr 3e-4;
  1.5e-3 and 3.5e-3 at lr 3e-3), while the losses agree to 2e-7;
- the ``Trainer`` (loss decreases, restart after an injected failure)
  and the data pipeline (the reference's tokens, before and after
  resume), and ``launch.train`` end to end;
- the forward-only CUDA kernels refuse to run under autograd.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.data.pipeline import ShardedTokenPipeline as JPipeline
from repro.models import init_params as j_init
from repro.models import loss_fn as j_loss
from repro.sharding.specs import ShardingRules as JRules
from repro.train.optimizer import OptConfig as JOpt
from repro.train.optimizer import adamw_update as j_adamw
from repro.train.optimizer import init_opt_state as j_init_opt
from repro.train.train_step import make_train_step as j_make_step
from repro.transfer.compression import compress as j_compress
from repro_torch import convert, models
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.data.pipeline import ShardedTokenPipeline
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as t_attn
from repro_torch.sharding.specs import ShardingRules
from repro_torch.train import OptConfig, adamw_update, init_opt_state
from repro_torch.train import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.transfer.compression import compress
from repro_torch.tree import tree_leaves, tree_map

from test_torch_cases import qkv, ssd_inputs
from test_torch_cases import one_thread  # noqa: F401

J_RULES = JRules(batch=None, fsdp=None, tp=None)
RULES = ShardingRules(batch=None, fsdp=None, tp=None)
ARCH_NAMES = ["smollm-135m", "zamba2-7b", "mamba2-1.3b"]
B, S, CHUNK = 2, 32, 16  # two loss chunks; S on the reduced SSD chunk grid


def _cfgs(arch: str, **kw):
    """f32 reduced configs of both packages (``reduced`` turns remat off;
    the remat tests turn it back on)."""
    j = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32",
                            loss_chunk=CHUNK, **kw)
    t = dataclasses.replace(t_reduced(T_ARCHS[arch]), dtype="float32",
                            loss_chunk=CHUNK, **kw)
    return j, t


def _batch(cfg, seed: int = 0, b: int = B, s: int = S) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _port_params(jparams):
    return convert.params_from_state(convert.params_state(jparams), "cpu")


def _rel_close(got: dict, want: dict, tol: float):
    """Each leaf within ``tol`` of its largest reference value."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        assert g.shape == w.shape, k
        err = np.abs(g - w).max(initial=0.0)
        assert err <= tol * max(np.abs(w).max(initial=0.0), 1e-30), (k, err)


@functools.lru_cache(maxsize=None)
def _j_loss_and_grads(arch: str):
    jcfg, _ = _cfgs(arch)
    params = j_init(jcfg, jax.random.PRNGKey(1))
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: j_loss(jcfg, J_RULES, p, batch), has_aux=True)(params)
    return params, float(loss), convert.params_state(grads)


@pytest.mark.parametrize("policy", ["full", "none", "dots"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_gradients_match_reference(arch, policy):
    params, j_loss_value, j_grads = _j_loss_and_grads(arch)
    _, tcfg = _cfgs(arch, remat=True, remat_policy=policy)
    tparams = _port_params(params)
    live = tree_map(lambda t: t.requires_grad_(True), tparams)
    batch = {k: torch.tensor(v) for k, v in _batch(tcfg).items()}
    loss, metrics = models.loss_fn(tcfg, RULES, live, batch)
    loss.backward()
    assert float(metrics["tokens"]) == B * S
    np.testing.assert_allclose(float(loss.detach()), j_loss_value,
                               rtol=1e-5)
    grads = convert.params_state(tree_map(lambda t: t.grad, live))
    _rel_close(grads, j_grads, 1e-4)


@pytest.mark.parametrize("policy,calls", [("full", 2), ("dots", 2),
                                          ("none", 1)])
def test_remat_recomputes_blocks_in_the_backward(policy, calls, monkeypatch):
    """Under "full" and "dots" each block's attention runs again in the
    backward pass; "none" keeps the forward's activations."""
    _, tcfg = _cfgs("smollm-135m", remat=True, remat_policy=policy)
    seen = []
    inner = t_attn.self_attention

    def counted(*a, **kw):
        seen.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(t_attn, "self_attention", counted)
    params = models.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    live = tree_map(lambda t: t.requires_grad_(True), params)
    batch = {k: torch.tensor(v) for k, v in _batch(tcfg).items()}
    loss, _ = models.loss_fn(tcfg, RULES, live, batch)
    n_fwd = len(seen)
    assert n_fwd == tcfg.num_layers
    loss.backward()
    assert len(seen) == calls * n_fwd


def test_adamw_ten_steps_match_reference():
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 7), "b": {"x": (3,), "y": (2, 2, 4)}}

    def draw(scale):
        return tree_map(lambda s: (rng.standard_normal(s) * scale
                                   ).astype(np.float32), shapes)

    p0 = draw(1.0)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=10, clip_norm=2.0)
    jp = tree_map(jnp.asarray, p0)
    js = j_init_opt(jp)
    tp = tree_map(torch.tensor, p0)
    ts = init_opt_state(tp)
    for _ in range(10):
        g = draw(0.7)
        jp, js, jm = j_adamw(tree_map(jnp.asarray, g), jp, js, JOpt(**cfg))
        tp, ts, tm = adamw_update(tree_map(torch.tensor, g), tp, ts,
                                  OptConfig(**cfg))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 10
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def _hooks():
    """The same composition on both sides: every gradient leaf through
    ``compress(..., use_pallas=True)``."""
    return (lambda g: jax.tree.map(lambda t: j_compress(t, use_pallas=True),
                                   g),
            lambda g: tree_map(lambda t: compress(t, use_pallas=True), g))


def _three_steps(microbatches: int = 1, hooked: bool = False):
    """3 steps of both packages' train step from the same parameters and
    pipeline batches; returns the losses and final parameters of each."""
    jcfg, tcfg = _cfgs("smollm-135m")
    opt = dict(warmup_steps=1, total_steps=3)
    jhook, thook = _hooks() if hooked else (None, None)
    jstep = jax.jit(j_make_step(jcfg, J_RULES, JOpt(**opt),
                                microbatches=microbatches,
                                grad_transform=jhook))
    tstep = make_train_step(tcfg, RULES, OptConfig(**opt),
                            microbatches=microbatches, grad_transform=thook)
    jparams = j_init(jcfg, jax.random.PRNGKey(3))
    jopt = j_init_opt(jparams)
    tparams = _port_params(jparams)
    topt = convert.opt_state_from_state(convert.params_state(jopt), "cpu")
    pipe = JPipeline(jcfg, global_batch=4, seq_len=S, seed=5)
    jl, tl = [], []
    for _ in range(3):
        batch = next(pipe)
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, topt, tm = tstep(tparams, topt,
                                  convert.batch_from_numpy(batch, "cpu"))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert int(topt["step"]) == 3
    return (jl, convert.params_state(jparams)), (tl, convert.params_state(
        tparams))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_three_steps_match_jitted_reference(microbatches):
    (jl, jp), (tl, tp) = _three_steps(microbatches)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    _rel_close(tp, jp, 1e-4)


def test_compression_hook_is_bitwise_and_trajectory_close():
    params, _, j_grads = _j_loss_and_grads("smollm-135m")
    jg = {k: jnp.asarray(v) for k, v in j_grads.items()}
    tg = {k: torch.tensor(v) for k, v in j_grads.items()}
    _, thook = _hooks()
    got = thook(tg)
    for k, v in jg.items():
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(j_compress(v)), err_msg=k)
    (jl, jp), (tl, tp) = _three_steps(hooked=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    _rel_close(tp, jp, 1e-3)


def test_trainer_loss_decreases(tmp_path):
    _, cfg = _cfgs("smollm-135m")
    cfg = dataclasses.replace(cfg, dtype="bfloat16", loss_chunk=64)
    trainer = Trainer(
        cfg,
        TrainerConfig(steps=25, global_batch=4, seq_len=64, ckpt_every=100,
                      ckpt_dir=str(tmp_path), log_every=1),
        opt_cfg=OptConfig(lr=5e-3, warmup_steps=2, total_steps=25),
        device="cpu",
    )
    losses = trainer.run()["losses"]
    assert len(losses) == 25
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.005


def test_trainer_restarts_after_injected_failure(tmp_path):
    _, cfg = _cfgs("smollm-135m")
    fail_at = {7}
    saved = []
    trainer = Trainer(
        cfg,
        TrainerConfig(steps=12, global_batch=2, seq_len=32, ckpt_every=5,
                      ckpt_dir=str(tmp_path), log_every=2),
        opt_cfg=OptConfig(lr=1e-3, warmup_steps=2, total_steps=12),
        failure_injector=lambda s: s in fail_at and not fail_at.discard(s),
        on_checkpoint=lambda path, step: saved.append((path.name, step)),
        device="cpu",
        grad_transform=_hooks()[1],
    )
    res = trainer.run()
    assert res["restarts"] == 1
    assert res["final_step"] == 12
    assert saved == [("step_00000005", 5), ("step_00000010", 10),
                     ("step_00000012", 12)]
    assert all(np.isfinite(res["losses"]))


def test_pipeline_tokens_match_reference_and_resume():
    jcfg, tcfg = _cfgs("smollm-135m")
    j = JPipeline(jcfg, global_batch=2, seq_len=16, seed=9)
    t = ShardedTokenPipeline(tcfg, global_batch=2, seq_len=16, seed=9)
    for _ in range(3):
        jb, tb = next(j), next(t)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k], jb[k])
    assert t.state_dict() == j.state_dict()
    resumed = ShardedTokenPipeline(tcfg, global_batch=2, seq_len=16, seed=9)
    resumed.load_state_dict(j.state_dict())
    for _ in range(2):
        np.testing.assert_array_equal(next(resumed)["tokens"],
                                      next(j)["tokens"])


def test_train_cli_runs_on_the_cpu(tmp_path):
    out = tmp_path / "metrics.json"
    rc = train_cli.main(["--steps", "3", "--batch", "2", "--seq", "32",
                         "--device", "cpu", "--ckpt-dir",
                         str(tmp_path / "ckpt"), "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert res["final_step"] == 3 and len(res["losses"]) == 3
    assert (tmp_path / "ckpt" / "step_00000003" / "COMMITTED").exists()


def test_forward_only_kernels_refuse_autograd():
    """Before any build or launch, on the CPU as on the card: inputs that
    require grad under grad mode raise; under no_grad, or with inputs
    that need no grad, the wrappers run."""
    q, k, v = (torch.tensor(a) for a in qkv(0, 1, 16, 2, 2, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape
    args = [torch.tensor(a) for a in ssd_inputs(0, 1, 2, 16, 4, 4,
                                                 layout="bshp")]
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(args[0], args[1].requires_grad_(True), *args[2:], chunk=8)
    args[1].requires_grad_(False)
    assert ssd_scan(*args, chunk=8)[0].shape == args[0].shape


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b"])
def test_training_through_the_kernels_raises(arch):
    """``use_pallas=True`` routes attention / the SSD scan through the
    forward-only kernels: the loss refuses rather than drop gradients,
    while the no-grad forward of serving still runs."""
    _, tcfg = _cfgs(arch, use_pallas=True)
    params = models.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.tensor(v) for k, v in _batch(tcfg).items()}
    assert models.forward(tcfg, RULES, params, batch).shape == (B, S, 64)
    live = tree_map(lambda t: t.requires_grad_(True), params)
    with pytest.raises(RuntimeError, match="no backward"):
        models.loss_fn(tcfg, RULES, live, batch)
