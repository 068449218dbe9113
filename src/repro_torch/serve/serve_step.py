"""Serving steps: prefill (prompt -> caches) and serve_step (one new token
against a KV/SSM state), the port of ``repro/serve/serve_step.py``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, prefill
from repro_torch.sharding.specs import ShardingRules, unshard


def make_prefill_step(cfg: ModelConfig, rules: ShardingRules, *, t_max: int):
    def prefill_step(params, batch):
        return prefill(cfg, rules, params, batch, t_max=t_max)

    return prefill_step


def make_serve_step(cfg: ModelConfig, rules: ShardingRules, *,
                    greedy: bool = True):
    """serve_step(params, state, tokens[B,1]) -> (next_tokens[B,1] int32,
    state); the state's caches are updated in place. Both settings of
    ``greedy`` take the argmax, as the reference's do. A caller that needs
    the logits calls ``decode_step`` itself."""
    del greedy  # the reference samples greedily either way

    def serve_step(params, state, tokens):
        logits, state = decode_step(cfg, rules, params, state, tokens)
        # the argmax reads each row whole over the vocab
        logits = unshard(logits, -1)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], state

    return serve_step
