"""The port's serving loop against the reference's, on the CPU.

Reduced Zamba2 in f32 with ``use_pallas=True`` (the serving entry's
setting), JAX parameters converted leaf for leaf: the reference's
``prefill`` then its ``make_serve_step`` greedy loop, against the port's
``launch.serve.generate`` (its ``make_prefill_step`` + ``make_serve_step``),
8 steps. Tokens must be equal and logits within 1e-4 (f32, the
frameworks' summation orders; measured ~1e-5).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
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

STEPS, B, S = 8, 2, 24


def test_greedy_serving_matches_reference():
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
    got = serve.generate(tcfg, tparams, torch.tensor(toks), STEPS)
    assert got["tokens"].shape == (B, STEPS)
    np.testing.assert_array_equal(got["tokens"].numpy(), want_tokens)
    np.testing.assert_allclose(got["logits"].numpy(), want_logits, atol=1e-4,
                               rtol=1e-4)


def test_cli_main_returns_its_numbers_on_cpu():
    out = serve.main(["--arch", "zamba2-7b", "--batch", "2", "--prompt-len",
                      "20", "--decode", "4", "--device", "cpu"])
    assert out["device"] == "cpu" and out["decode_steps"] == 3
    assert out["params"] == serve.count_params(
        dataclasses.replace(t_reduced(T_ARCHS["zamba2-7b"])))
    assert out["prefill_s"] > 0 and out["decode_tok_s"] > 0
    assert len(out["sample_tokens"]) == 4
