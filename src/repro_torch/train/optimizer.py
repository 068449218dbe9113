"""AdamW with warmup+cosine schedule and global-norm clipping (the port of
``repro/train/optimizer.py``).

The state is {"m": tree, "v": tree, "step": 0-d int32 tensor}. The update
runs under ``torch.no_grad()`` and writes the parameters and the moments
IN PLACE (the reference returns new trees; the port keeps one copy of the
largest tensors of training). The returned trees are the same tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def init_opt_state(params) -> dict:
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "step": step,
    }


def opt_state_logical(param_logical) -> dict:
    return {"m": param_logical, "v": param_logical, "step": ()}


def schedule(cfg: OptConfig, step):
    """The learning rate at ``step`` (a 0-d tensor), as a 0-d f32 tensor."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree):
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g in tree_leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


@torch.no_grad()
def adamw_update(grads, params, state, cfg: OptConfig):
    """Returns (params, state, metrics); params and the moments are
    updated in place (module docstring)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p
        p.sub_(lr * delta)

    tree_map(upd, params, grads, state["m"], state["v"])
    return (params, {"m": state["m"], "v": state["v"], "step": step},
            {"grad_norm": gnorm, "lr": lr})
