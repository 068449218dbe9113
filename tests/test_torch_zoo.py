"""The rest of the model zoo in the port, against the reference, on the CPU:
Mixtral (MoE + sliding window), Qwen3-MoE, Llama-3.2-Vision (cross-
attention every 5th layer) and Seamless (encoder-decoder), reduced, f32,
the reference's parameters converted leaf for leaf.

- ``loss_fn`` and its gradients (autograd against ``jax.grad``) under
  every remat policy, ``use_pallas=False``: the loss within 1e-5, each
  gradient leaf within 1e-4 of its largest reference value (the
  frameworks' summation orders); and a training step on the data
  pipeline's batch (its vision tokens or frames reach ``loss_fn``, split
  into microbatches), the loss against the reference's on that batch;
- decode from ``init_decode_state`` (no prefill) for 20 greedy steps:
  Mixtral's ring buffer of 16 (its reduced window) wraps; the VLM's
  vision tokens and the encoder-decoder's ``memory`` (the raw frames, as
  the reference's state holds them) come from ``batch_extras``; logits
  within 1e-4 and the same tokens;
- ``launch.inputs``: every stand-in's shape and type and every logical
  tree equal the reference's, for all 10 architectures;
- the serving CLI on the CPU feeds ``vision`` / ``frames``;
- the new parameter trees and decode states round-trip through
  ``convert`` leaf for leaf.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, SHAPES, reduced
from repro.launch import inputs as j_inputs
from repro.models import decode_step as j_decode
from repro.models import init_decode_state as j_init_state
from repro.models import init_params as j_init
from repro.models import loss_fn as j_loss
from repro.sharding.specs import ShardingRules as JRules
from repro_torch import convert, models
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import reduced as t_reduced
from repro_torch.data.pipeline import ShardedTokenPipeline
from repro_torch.launch import inputs, serve
from repro_torch.sharding.specs import ShardingRules
from repro_torch.train import OptConfig, init_opt_state, make_train_step
from repro_torch.tree import tree_map

J_RULES = JRules(batch=None, fsdp=None, tp=None)
RULES = ShardingRules(batch=None, fsdp=None, tp=None)
ZOO = ["llama-3.2-vision-11b", "mixtral-8x22b", "qwen3-moe-30b-a3b",
       "seamless-m4t-medium"]
B, S, CHUNK = 2, 32, 16
STEPS = 20  # decode steps from a fresh state: past Mixtral's window of 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS, OpenMP and intra-op thread while this module runs: the
    suite runs in several worker processes at once."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _cfgs(arch: str, **kw):
    j = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32",
                            loss_chunk=CHUNK, **kw)
    t = dataclasses.replace(t_reduced(T_ARCHS[arch]), dtype="float32",
                            loss_chunk=CHUNK, **kw)
    return j, t


def _batch(cfg) -> dict:
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.is_vlm:
        out["vision"] = rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_enc_dec:
        out["frames"] = rng.standard_normal(
            (B, cfg.num_frames, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _j_params(arch: str):
    jcfg, _ = _cfgs(arch)
    return j_init(jcfg, jax.random.PRNGKey(1))


def _port_params(jparams):
    return convert.params_from_state(convert.params_state(jparams), "cpu")


@functools.lru_cache(maxsize=None)
def _j_loss_and_grads(arch: str):
    jcfg, _ = _cfgs(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: j_loss(jcfg, J_RULES, p, batch), has_aux=True)(
            _j_params(arch))
    return float(loss), convert.params_state(grads)


@pytest.mark.parametrize("policy", ["full", "none", "dots"])
@pytest.mark.parametrize("arch", ZOO)
def test_loss_and_gradients_match_reference(arch, policy):
    j_loss_value, j_grads = _j_loss_and_grads(arch)
    _, tcfg = _cfgs(arch, remat=True, remat_policy=policy)
    live = tree_map(lambda t: t.requires_grad_(True),
                    _port_params(_j_params(arch)))
    batch = {k: torch.tensor(v) for k, v in _batch(tcfg).items()}
    loss, metrics = models.loss_fn(tcfg, RULES, live, batch)
    loss.backward()
    assert float(metrics["tokens"]) == B * S
    np.testing.assert_allclose(float(loss.detach()), j_loss_value, rtol=1e-5)
    grads = convert.params_state(tree_map(lambda t: t.grad, live))
    assert sorted(grads) == sorted(j_grads)
    for k, w in j_grads.items():
        err = np.abs(grads[k].astype(np.float64) - w).max(initial=0.0)
        assert err <= 1e-4 * max(np.abs(w).max(initial=0.0), 1e-30), (k, err)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_train_step_feeds_the_pipelines_frontend_inputs(arch):
    jcfg, tcfg = _cfgs(arch)
    batch = next(ShardedTokenPipeline(tcfg, global_batch=B, seq_len=S))
    assert ("vision" in batch) == tcfg.is_vlm
    assert ("frames" in batch) == tcfg.is_enc_dec
    want, _ = j_loss(jcfg, J_RULES, _j_params(arch),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    params = _port_params(_j_params(arch))
    step = make_train_step(tcfg, RULES, OptConfig(), microbatches=2)
    _, _, metrics = step(params, init_opt_state(params),
                         {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(want),
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_decode_from_a_fresh_state_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    params = _j_params(arch)
    extras = {k: v for k, v in _batch(jcfg).items()
              if k in ("vision", "frames")}
    jstate = j_init_state(jcfg, B, STEPS, batch_extras={
        k: jnp.asarray(v) for k, v in extras.items()})
    tstate = models.init_decode_state(
        tcfg, B, STEPS, device="cpu",
        batch_extras={k: torch.tensor(v) for k, v in extras.items()})
    if arch == "mixtral-8x22b":
        assert tstate["kv"]["k"].shape[-3] == 16 < STEPS  # the ring wraps
    if arch == "seamless-m4t-medium":  # the raw frames, not the encoder's
        np.testing.assert_array_equal(tstate["memory"].numpy(),
                                      extras["frames"])
    tparams = _port_params(params)
    step = jax.jit(lambda p, s, t: j_decode(jcfg, J_RULES, p, s, t))
    tok = np.asarray(_batch(jcfg)["tokens"][:, :1])
    for i in range(STEPS):
        jl, jstate = step(params, jstate, jnp.asarray(tok))
        tl, tstate = models.decode_step(tcfg, RULES, tparams, tstate,
                                        torch.tensor(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {i}")
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(
            torch.argmax(tl, -1).numpy(), tok[:, 0])


def _spec(x) -> tuple:
    """(shape, dtype name) of a stand-in of either package."""
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _specs(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_specs(v, f"{prefix}.{k}"))
        return out
    if isinstance(tree, tuple):  # a logical-axes leaf
        return {prefix: tree}
    return {prefix: _spec(tree)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_stand_ins_match_reference(arch):
    jc, tc = ARCHS[arch], T_ARCHS[arch]
    for name in ("train_4k", "decode_32k"):
        js, ts = SHAPES[name], T_SHAPES[name]
        assert (_specs(inputs.train_batch_sds(tc, ts))
                == _specs(j_inputs.train_batch_sds(jc, js)))
        state = inputs.decode_state_sds(tc, ts)
        assert all(t.device.type == "meta" for t in _leaves(state))
        assert _specs(state) == _specs(j_inputs.decode_state_sds(jc, js))
        assert (_spec(inputs.decode_tokens_sds(tc, ts))
                == _spec(j_inputs.decode_tokens_sds(jc, js)))
    assert inputs.train_batch_logical(tc) == j_inputs.train_batch_logical(jc)
    assert (_specs(inputs.decode_logical(tc))
            == _specs(j_inputs.decode_logical(jc)))
    for dt in (None, "bfloat16"):
        got = inputs.param_sds(tc, dt)
        assert all(t.device.type == "meta" for t in _leaves(got))
        assert _specs(got) == _specs(j_inputs.param_sds(jc, dt))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ZOO)
def test_serve_cli_feeds_the_frontends_on_cpu(arch):
    out = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "20",
                      "--decode", "4", "--device", "cpu"])
    cfg = t_reduced(T_ARCHS[arch])
    want = {}
    if cfg.is_vlm:
        want["vision"] = [2, cfg.num_vision_tokens, cfg.d_model]
    if cfg.is_enc_dec:
        want["frames"] = [2, cfg.num_frames, cfg.d_model]
    assert out["extras"] == want
    assert out["params"] == models.count_params(cfg)
    assert out["decode_steps"] == 3 and len(out["sample_tokens"]) == 4
    assert out["prefill_s"] > 0 and out["decode_tok_s"] > 0


@pytest.mark.parametrize("arch", ZOO)
def test_new_trees_round_trip_through_convert(arch):
    """Parameters (``ffn.router/wi/wg/wo``, ``cross_blocks``, ``encoder``,
    ``dec_blocks.xattn``) and prefill states (``memory``, ``vision``)
    carried to numpy and back, leaf for leaf."""
    _, cfg = _cfgs(arch)
    params = models.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    st = convert.params_state(params)
    assert any(k.startswith(p) for k in st for p in (
        "decoder.blocks.ffn.router", "decoder.cross_blocks",
        "encoder.blocks", "decoder.dec_blocks.xattn"))
    back = convert.params_state(convert.params_from_state(st, "cpu"))
    assert back.keys() == st.keys()
    assert all(np.array_equal(back[k], st[k]) for k in st)
    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items()
             if k != "labels"}
    state, _ = models.prefill(cfg, RULES, params, batch, t_max=S + 2)
    ss = convert.params_state(state)
    again = convert.decode_state_from_state(ss, "cpu")
    assert again["pos"].dtype == torch.int32
    back = convert.params_state(again)
    assert back.keys() == ss.keys()
    assert all(np.array_equal(back[k], ss[k]) for k in ss)
    assert ("memory" in ss) == cfg.is_enc_dec and ("vision" in ss) == cfg.is_vlm
