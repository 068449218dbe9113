"""The port's serving loop against the reference's, on the CPU.

Reduced Zamba2 in f32 with ``use_pallas=True`` (the serving entry's
setting), JAX parameters converted leaf for leaf: the reference's
``prefill`` then its ``make_serve_step`` greedy loop, against the port's
``launch.serve.generate`` (its ``make_prefill_step``, then ``decode_step``
and the argmax), 8 steps, and against the port's ``make_serve_step``
with either setting of ``greedy``. Tokens must be equal and logits within
1e-4 (f32, the frameworks' summation orders; measured ~1e-5).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.models import decode_step as j_decode
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro.serve import make_serve_step as j_make_serve_step
from repro.sharding.specs import ShardingRules as JRules
from repro_torch import convert
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.launch import serve
from repro_torch.serve import make_prefill_step, make_serve_step
from test_torch_cases import one_thread  # noqa: F401

STEPS, B, S = 8, 2, 24


@pytest.fixture(scope="module")
def reference_run():
    """The reference's greedy serving loop on reduced zamba2 (f32), and
    the port's config, converted parameters and prompt."""
    jcfg = dataclasses.replace(reduced(ARCHS["zamba2-7b"]), dtype="float32",
                               use_pallas=True)
    tcfg = dataclasses.replace(t_reduced(T_ARCHS["zamba2-7b"]),
                               dtype="float32", use_pallas=True)
    rules = JRules(batch=None, fsdp=None, tp=None)
    params = j_init(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)

    state, logits = j_prefill(jcfg, rules, params,
                              {"tokens": jnp.asarray(toks)}, t_max=S + STEPS)
    serve_step = jax.jit(j_make_serve_step(jcfg, rules))
    step_logits = jax.jit(lambda p, s, t: j_decode(jcfg, rules, p, s, t)[0])
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want_tokens, want_logits = [tok], [logits]
    for _ in range(STEPS - 1):
        want_logits.append(step_logits(params, state, tok))
        tok, state = serve_step(params, state, tok)
        want_tokens.append(tok)
    want_tokens = np.concatenate([np.asarray(t) for t in want_tokens], 1)
    want_logits = np.stack([np.asarray(t) for t in want_logits])
    tparams = convert.params_from_state(convert.params_state(params), "cpu")
    return tcfg, tparams, toks, want_tokens, want_logits


def test_greedy_serving_matches_reference(reference_run):
    tcfg, tparams, toks, want_tokens, want_logits = reference_run
    got = serve.generate(tcfg, tparams, torch.tensor(toks), STEPS)
    assert got["tokens"].shape == (B, STEPS)
    np.testing.assert_array_equal(got["tokens"].numpy(), want_tokens)
    np.testing.assert_allclose(got["logits"].numpy(), want_logits, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("greedy", [True, False])
def test_serve_step_keeps_the_reference_contract(reference_run, greedy):
    """``serve_step`` returns (next_tokens [B,1] int32, state), as the
    reference's does, and takes the argmax with either ``greedy``."""
    tcfg, tparams, toks, want_tokens, _ = reference_run
    state, logits = make_prefill_step(tcfg, serve.RULES, t_max=S + STEPS)(
        tparams, {"tokens": torch.tensor(toks)})
    serve_step = make_serve_step(tcfg, serve.RULES, greedy=greedy)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    got = [tok]
    for _ in range(STEPS - 1):
        out = serve_step(tparams, state, tok)
        assert len(out) == 2
        tok, state = out
        assert tok.shape == (B, 1) and tok.dtype == torch.int32
        got.append(tok)
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(), want_tokens)


def test_cli_main_returns_its_numbers_on_cpu():
    out = serve.main(["--arch", "zamba2-7b", "--batch", "2", "--prompt-len",
                      "20", "--decode", "4", "--device", "cpu"])
    assert out["device"] == "cpu" and out["decode_steps"] == 3
    assert out["params"] == serve.count_params(
        dataclasses.replace(t_reduced(T_ARCHS["zamba2-7b"])))
    assert out["prefill_s"] > 0 and out["decode_tok_s"] > 0
    assert len(out["sample_tokens"]) == 4
