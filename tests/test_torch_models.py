"""The port's models against the reference package's, on the CPU.

JAX parameters (``repro.models.init_params``) are converted leaf for leaf
(``repro_torch.convert.params_state`` / ``params_from_state``) and both
models run the same numpy tokens (and vision tokens or audio frames where
the model takes them), in f32, at ``reduced(...)`` size, for every
architecture of ``configs/archs.py`` (dense, MoE with and without a
sliding window, pure SSM, hybrid, VLM, encoder-decoder), with
``use_pallas`` False (einsum attention, ``ssd_chunked``) and True (the
reference's Pallas kernels in interpret mode against the port's plain
versions): ``forward`` hidden, ``prefill`` last logits and every cache
leaf (the VLM's vision and the encoder's memory too), and ``decode_step``
logits from the JAX prefill state handed to the port. f32 tolerance 1e-4:
the two frameworks sum in other orders (measured ~2e-5 here).

One bf16 case holds Zamba2 at a relative (Frobenius) error of 0.1: JAX
rounds each elementwise op of silu/gelu/the conv taps to bf16 while torch
computes them in f32 and rounds once, 1 ulp (2^-8) apart per op, and
random-weight sublayers compound that (measured 4.5% on the hidden state,
3.9% on the logits).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro.models.attention import attend as j_attend
from repro.models.attention import causal_mask as j_causal_mask
from repro.models.model import count_params as j_count
from repro.models.model import decode_state_logical as j_state_logical
from repro.models.model import param_logical as j_param_logical
from repro.sharding.specs import ShardingRules as JRules
from repro_torch import convert, models
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.models.attention import attend, causal_mask
from repro_torch.models import moe
from repro_torch.models.model import decode_state_logical
from repro_torch.sharding.specs import ShardingRules
from test_torch_cases import one_thread  # noqa: F401

J_RULES = JRules(batch=None, fsdp=None, tp=None)
RULES = ShardingRules(batch=None, fsdp=None, tp=None)
ARCH_NAMES = sorted(ARCHS)
B, S, T_MAX = 2, 40, 48  # S off the SSD chunk grid (16): the pad path
TOL = 1e-4


def _cfgs(arch: str, use_pallas: bool, dtype: str = "float32"):
    j = dataclasses.replace(reduced(ARCHS[arch]), dtype=dtype,
                            use_pallas=use_pallas)
    t = dataclasses.replace(t_reduced(T_ARCHS[arch]), dtype=dtype,
                            use_pallas=use_pallas)
    return j, t


def _tokens(cfg, n: int = S) -> np.ndarray:
    rng = np.random.default_rng(7)
    return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _extras(cfg) -> dict:
    """The stub frontends' inputs: vision tokens (VLM), frames (enc-dec)."""
    rng = np.random.default_rng(8)
    out = {}
    if cfg.is_vlm:
        out["vision"] = rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_enc_dec:
        out["frames"] = rng.standard_normal(
            (B, cfg.num_frames, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _run(arch: str, use_pallas: bool, dtype: str = "float32") -> dict:
    """Both models on the same parameters and tokens, as numpy."""
    jcfg, tcfg = _cfgs(arch, use_pallas, dtype)
    params = j_init(jcfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_state(convert.params_state(params), "cpu")
    batch = {"tokens": _tokens(jcfg), **_extras(jcfg)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    out = {
        "j_hidden": np.asarray(j_forward(jcfg, J_RULES, params, jb),
                               np.float32),
        "t_hidden": models.forward(tcfg, RULES, tparams, tb).float().numpy(),
    }
    jstate, jlog = j_prefill(jcfg, J_RULES, params, jb, t_max=T_MAX)
    tstate, tlog = models.prefill(tcfg, RULES, tparams, tb, t_max=T_MAX)
    out.update(j_logits=np.asarray(jlog), t_logits=tlog.numpy(),
               j_state=convert.params_state(jstate),
               t_state=convert.params_state(tstate))
    nxt = np.argmax(out["j_logits"], -1)[:, None].astype(np.int32)
    jdec, _ = j_decode(jcfg, J_RULES, params, jstate, jnp.asarray(nxt))
    handed = convert.decode_state_from_state(out["j_state"], "cpu")
    tdec, tnew = models.decode_step(tcfg, RULES, tparams, handed,
                                    torch.tensor(nxt))
    out.update(j_decode=np.asarray(jdec), t_decode=tdec.numpy(),
               t_pos=int(tnew["pos"]))
    return out


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_hidden_matches_reference(arch, use_pallas):
    r = _run(arch, use_pallas)
    assert r["t_hidden"].shape == (B, S, 64)
    np.testing.assert_allclose(r["t_hidden"], r["j_hidden"], atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_logits_and_caches_match_reference(arch, use_pallas):
    r = _run(arch, use_pallas)
    np.testing.assert_allclose(r["t_logits"], r["j_logits"], atol=TOL,
                               rtol=TOL)
    assert sorted(r["t_state"]) == sorted(r["j_state"])
    for key, want in r["j_state"].items():
        got = r["t_state"][key]
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), atol=TOL,
                                   rtol=TOL, err_msg=key)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_step_from_reference_state_matches(arch, use_pallas):
    r = _run(arch, use_pallas)
    assert r["t_pos"] == S + 1
    np.testing.assert_allclose(r["t_decode"], r["j_decode"], atol=TOL,
                               rtol=TOL)


def test_bf16_hybrid_within_stated_tolerance():
    r = _run("zamba2-7b", True, "bfloat16")
    for got, want in ((r["t_hidden"], r["j_hidden"]),
                      (r["t_logits"], r["j_logits"])):
        assert np.all(np.isfinite(got))
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 0.1, rel


@pytest.mark.parametrize("scores_bf16", [False, True])
def test_attend_matches_reference(scores_bf16):
    """The einsum attention in bf16, with f32 or bf16 score buffers
    (``cfg.attn_scores_bf16``), GQA 4:2 under a causal window mask:
    within bf16's 2e-2 of the reference."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = j_attend(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                    q_per_kv=2, mask=j_causal_mask(24, 24, window=8),
                    scale=0.25, scores_bf16=scores_bf16)
    got = attend(*(torch.tensor(t).to(torch.bfloat16) for t in (q, k, v)),
                 q_per_kv=2, mask=causal_mask(24, 24, window=8), scale=0.25,
                 scores_bf16=scores_bf16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_matches_prefill_extension(arch):
    """decode(prefill(t[:s]), t[s]) logits == prefill(t[:s+1]) last logits
    in the port alone: the KV/SSM caches carry exactly what the full
    forward sees (the reference's own check, at its 1e-3).

    Two reference behaviours are set aside, since they are not cache
    semantics: MoE capacity is per call (a prefill may drop an assignment
    that a one-token decode keeps), so the MoE models run at a capacity
    factor of num_experts / top_k, which drops nothing; and a decode
    after a prefill attends over every cached slot with no window mask
    (``repro/models/model.py:236-239``), so Mixtral runs with a window
    wider than the context (its decode past a prefill longer than the
    window is held against the reference's in
    ``test_decode_step_from_reference_state_matches``)."""
    _, cfg = _cfgs(arch, False)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        assert moe.capacity(cfg, B * (S + 1)) >= B * (S + 1)
    if cfg.sliding_window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=S + 1)
    params = models.init_params(cfg, torch.Generator().manual_seed(3),
                                "cpu")
    toks = torch.tensor(_tokens(cfg, S + 1))
    extras = {k: torch.tensor(v) for k, v in _extras(cfg).items()}
    state, _ = models.prefill(cfg, RULES, params,
                              {"tokens": toks[:, :S], **extras}, t_max=S + 1)
    step, _ = models.decode_step(cfg, RULES, params, state, toks[:, S:])
    _, full = models.prefill(cfg, RULES, params, {"tokens": toks, **extras})
    err = float((step - full).abs().max())
    assert err < 1e-3, f"{arch}: decode/prefill divergence {err}"


BUILT = sorted(ARCHS)


@pytest.mark.parametrize("arch", BUILT)
def test_count_params_matches_reference(arch):
    """Total and active (MoE: top_k of num_experts) parameters, full and
    reduced, and the logical axes of every parameter and decode-state
    leaf."""
    for jc, tc in ((ARCHS[arch], T_ARCHS[arch]),
                   (reduced(ARCHS[arch]), t_reduced(T_ARCHS[arch]))):
        for active in (False, True):
            assert (models.count_params(tc, active_only=active)
                    == j_count(jc, active_only=active))
        assert _flat(models.param_logical(tc)) == _flat(j_param_logical(jc))
        assert (_flat(decode_state_logical(tc))
                == _flat(j_state_logical(jc)))


def test_ssm_cache_logical_matches_reference():
    """The SSM cache's logical axes, which ``decode_logical`` gives a
    pure-SSM arch's decode state too."""
    from repro.models.ssm import ssm_cache_logical as j_ssm_cache_logical
    from repro_torch.models.ssm import ssm_cache_logical

    assert _flat(ssm_cache_logical()) == _flat(j_ssm_cache_logical())
    cfg = t_reduced(T_ARCHS["mamba2-1.3b"])
    assert _flat(decode_state_logical(cfg)["ssm"]) == _flat(
        ssm_cache_logical())


def _flat(tree, prefix="") -> dict:
    """A tree of logical-axis tuples as {dotted path: tuple}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}"))
        return out
    return {prefix: tuple(tree)}


def test_full_size_counts():
    """The sizes the card serves: zamba2-7b, llama-3.2-vision-11b,
    seamless-m4t-medium, and qwen3-moe-30b-a3b cut to 12 of its 48
    layers."""
    assert models.count_params(T_ARCHS["zamba2-7b"]) == 6_751_130_832
    assert (models.count_params(T_ARCHS["llama-3.2-vision-11b"])
            == 9_775_157_248)
    assert (models.count_params(T_ARCHS["seamless-m4t-medium"])
            == 977_758_208)
    qwen12 = dataclasses.replace(T_ARCHS["qwen3-moe-30b-a3b"], num_layers=12)
    assert models.count_params(qwen12) == 8_099_776_512


def test_init_params_runs_on_the_card_unless_told(monkeypatch):
    """With no device, parameters go to the card; with no card that raises
    rather than building the model on the CPU. A generator on another
    device than the parameters is refused."""
    cfg = t_reduced(T_ARCHS["smollm-135m"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="generator"):
        models.init_params(cfg, torch.Generator().manual_seed(0), "meta")
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params["final_norm"].device.type == "cpu"
