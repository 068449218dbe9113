"""The training step: loss -> grads -> AdamW, with optional microbatched
gradient accumulation and a pluggable gradient transform (the port of
``repro/train/train_step.py::make_train_step``; the pod-ring step waits
for the multi-device port).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import loss_fn
from repro_torch.sharding.specs import ShardingRules
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from .optimizer import OptConfig, adamw_update


def make_train_step(
    cfg: ModelConfig,
    rules: ShardingRules,
    opt_cfg: OptConfig,
    *,
    microbatches: int = 1,
    grad_transform: Callable | None = None,
):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); params and the moments are updated in place.

    grad_transform: optional hook applied to the f32 grad tree before the
    optimizer (e.g. int8 compression, ``transfer.compression.compress``).
    """
    dt = getattr(torch, cfg.dtype)

    def lw(p, b):
        if cfg.cast_params_once:
            # cast the whole tree to the compute dtype up front; the cast
            # is linear, so grads flow back to the f32 masters unchanged
            p = tree_map(
                lambda t: t.to(dt) if t.dtype == torch.float32 else t, p
            )
        return loss_fn(cfg, rules, p, b)

    def compute_grads(params, batch):
        # leaves that share the parameters' storage and collect grads
        live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        p = tree_unflatten(params, live)
        if microbatches == 1:
            loss, metrics = lw(p, batch)
            loss.backward()
            grads = tree_unflatten(params, [t.grad for t in live])
            return grads, loss.detach(), {
                k: v.detach() for k, v in metrics.items()}
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches}")
        mb = b // microbatches
        loss_sum = torch.zeros((), dtype=torch.float32, device=live[0].device)
        for i in range(microbatches):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _ = lw(p, part)
            loss.backward()  # grads add up in each leaf's .grad, in f32
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / microbatches
        grads = tree_unflatten(params, [t.grad * inv for t in live])
        loss = loss_sum * inv
        return grads, loss, {"loss": loss}

    def train_step(params, opt_state, batch):
        grads, loss, metrics = compute_grads(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = adamw_update(
            grads, params, opt_state, opt_cfg
        )
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
