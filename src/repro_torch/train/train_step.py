"""The training step: loss -> grads -> AdamW, with optional microbatched
gradient accumulation and a pluggable gradient transform, and the pod-ring
step, whose ranks average their gradients over the planner-ordered,
optionally int8-compressed ring of ``repro_torch.transfer.collective``
(the port of ``repro/train/train_step.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models import loss_fn
from repro_torch.sharding.specs import (ShardingRules, current_mesh,
                                        from_local, is_dtensor, local_call,
                                        mesh_axis_sizes, set_mesh)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from .optimizer import OptConfig, adamw_update


def _loss_with_cast(cfg: ModelConfig, rules: ShardingRules):
    """loss_fn(cfg, rules, params, batch), the parameters cast to the
    compute dtype first when ``cfg.cast_params_once``."""
    dt = getattr(torch, cfg.dtype)

    def lw(p, b):
        if cfg.cast_params_once:
            # cast the whole tree to the compute dtype up front; the cast
            # is linear, so grads flow back to the f32 masters unchanged
            p = tree_map(
                lambda t: t.to(dt) if t.dtype == torch.float32 else t, p
            )
        return loss_fn(cfg, rules, p, b)

    return lw


def _batch_size(batch) -> int:
    return next(iter(batch.values())).shape[0]


def _placed_like(grad, param):
    """A DTensor gradient redistributed to its parameter's placements.
    Autograd hands a weight replicated over a mesh axis its gradient as a
    partial sum over that axis; this is where XLA's jit reduces it."""
    if is_dtensor(param) and grad.placements != param.placements:
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def _grads(params, live, scale: float = 1.0):
    """The tree of the ``live`` leaves' gradients, times ``scale``, each
    on its parameter's placements."""
    return tree_unflatten(params, [
        _placed_like(t.grad if scale == 1.0 else t.grad * scale, p)
        for t, p in zip(live, tree_leaves(params))])


def _value_and_grad(lw, params, batch):
    """(loss, metrics, grads) of one backward pass, detached."""
    # leaves that share the parameters' storage and collect grads
    live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = lw(tree_unflatten(params, live), batch)
    loss.backward()
    grads = _grads(params, live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


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
    lw = _loss_with_cast(cfg, rules)

    def compute_grads(params, batch):
        if microbatches == 1:
            loss, metrics, grads = _value_and_grad(lw, params, batch)
            return grads, loss, metrics
        # leaves that share the parameters' storage and collect grads
        live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        p = tree_unflatten(params, live)
        b = _batch_size(batch)
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
        grads = _grads(params, live, inv)
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


def make_podring_train_step(
    cfg: ModelConfig,
    rules: ShardingRules,
    opt_cfg: OptConfig,
    mesh,
    *,
    compress_wire: bool = True,
    pod_tput=None,
):
    """Inter-pod DP with an explicit, planner-ordered, optionally int8-
    compressed ring all-reduce (the paper's egress-volume lever applied to
    gradients on the inter-pod links).

    Every rank of ``mesh`` (a DeviceMesh with a "pod" axis) runs
    step(params, opt_state, batch) -> (params, opt_state, metrics). Its pod
    takes the ``P("pod")`` shard of the global batch, rows ``[p b / n,
    (p + 1) b / n)`` for its index ``p`` along the pod axis, computes the
    loss and gradients as ``make_train_step`` does, averages the gradients
    over the ring (int8 + scales on the wire when ``compress_wire``), and
    runs AdamW on the parameters and moments, in place. ``metrics["loss"]``
    is the pod mean.

    Plain parameters: one rank per pod, which holds a replica of the
    parameters and moments and the whole global batch. DTensor parameters
    (the reference's ``shard_map``, manual over "pod" and automatic over
    the rest): parameters and moments ``Replicate`` over "pod" and placed
    over the other axes by ``make_param_shardings``, the global batch a
    DTensor (``shardings_for`` places it). Each pod computes on the
    sub-mesh of its other axes (``rules.batch = "data"`` inside), and each
    rank runs the ring on its local shards over its own pod group."""
    from repro_torch.transfer import collective

    sizes = mesh_axis_sizes(mesh)
    if "pod" not in sizes:
        raise ValueError(f"no pod axis in the mesh {tuple(sizes)}")
    n_pods = sizes["pod"]
    order = collective.choose_ring_order(
        pod_tput if pod_tput is not None else np.ones((n_pods, n_pods))
    )
    group = mesh.get_group("pod")
    # inside one pod, batch parallelism only spans 'data'
    lw = _loss_with_cast(cfg, dataclasses.replace(rules, batch="data"))

    def ring(grads):
        return collective.ring_allreduce_tree(
            grads, group, order, compress_wire=compress_wire, mean=True
        )

    def step(params, opt_state, batch):
        b = _batch_size(batch)
        if b % n_pods:
            raise ValueError(f"batch {b} does not split over {n_pods} pods")
        if is_dtensor(tree_leaves(params)[0]):
            loss, metrics, grads = _pod_grads(lw, mesh, params, batch, ring)
        else:
            p, rows = dist.get_rank(group), b // n_pods
            local = {k: v[p * rows:(p + 1) * rows] for k, v in batch.items()}
            loss, metrics, grads = _value_and_grad(lw, params, local)
            grads = ring(grads)
        params, opt_state, opt_metrics = adamw_update(
            grads, params, opt_state, opt_cfg
        )
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = _pod_mean(loss, group, n_pods)
        return params, opt_state, metrics

    return step


def _pod_grads(lw, mesh, params, batch, ring):
    """(loss, metrics, gradients) of one pod on DTensor parameters: the
    loss on the sub-mesh of the axes but "pod" (``lw``'s rules, the mesh
    set to the sub-mesh meanwhile), then ``ring`` over each rank's local
    gradient shards. The loss comes back as this rank's plain value, the
    gradients as DTensors on ``mesh`` on their parameters' placements."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axis_sizes(mesh))
    pod = names.index("pod")
    inner = mesh[tuple(n for n in names if n != "pod")]

    def drop_pod(pl):
        return tuple(x for i, x in enumerate(pl) if i != pod)

    def to_inner(t):
        if t.placements[pod] != Replicate():
            raise ValueError(f"a parameter placed {t.placements} is not "
                             f"replicated over the pod axis")
        return from_local(t.to_local(), inner, drop_pod(t.placements),
                          t.shape)

    def rows(t):  # the pod's rows, as placed over the other axes
        want = list(t.placements)
        want[pod] = Shard(0)
        t = t.redistribute(mesh, want)
        return from_local(t.to_local(), inner, drop_pod(want),
                          (t.shape[0] // mesh.size(pod), *t.shape[1:]))

    prev = current_mesh()
    set_mesh(inner)
    try:
        loss, metrics, grads = _value_and_grad(
            lw, tree_map(to_inner, params), tree_map(rows, batch))
    finally:
        set_mesh(prev)
    leaves = tree_leaves(grads)

    def ring_local(*local):
        return tuple(tree_leaves(ring(tree_unflatten(grads, list(local)))))

    reduced = local_call(ring_local, leaves, [g.placements for g in leaves],
                         [g.placements for g in leaves],
                         [g.shape for g in leaves])
    grads = tree_map(
        lambda g, p: from_local(g.to_local(), mesh, p.placements, p.shape),
        tree_unflatten(grads, list(reduced)), params)
    return loss.to_local(), metrics, grads


def _pod_mean(x, group, n: int):
    """The mean of a 0-d tensor over ``group``: an all-reduce sum (through
    host memory on gloo), then ``mean_of_sum``."""
    from repro_torch.transfer import collective

    wire = "cpu" if dist.get_backend(group) == "gloo" else x.device
    total = x.to(wire, copy=True)
    dist.all_reduce(total, group=group)
    return collective.mean_of_sum(total.to(x.device), n)
