"""Elastic rescaling: pod join/leave -> new mesh + Skyplane-planned reshard
(the port of ``repro/launch/elastic.py``).

When the pod count changes, parameters/optimizer state must move between
pods. The movement matrix (bytes from pod i's region to pod j's region) is
exactly a set of bulk transfers — so the reshard schedule comes from the
Skyplane planner, and at fleet scale would execute on the same gateway data
plane as checkpoint replication. On one host the state movement itself is
a ``distribute_tensor`` onto the new mesh's placements (logical
correctness), while the planner output prices/schedules the inter-region
movement.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.planner import Planner
from repro_torch.core.spec import PlanSpec
from repro_torch.core.topology import Topology
from repro_torch.models.model import abstract_params
from repro_torch.sharding.specs import ShardingRules, make_param_shardings
from repro_torch.tree import tree_map
from .mesh import make_mesh_for


@dataclasses.dataclass
class ReshardPlan:
    old_pods: int
    new_pods: int
    moves: list  # (src_region, dst_region, gb, tput_gbps, cost)
    total_gb: float
    total_cost: float
    est_time_s: float


def plan_reshard(
    cfg,
    top: Topology,
    pod_regions_old: list[str],
    pod_regions_new: list[str],
    *,
    bytes_per_param: int = 12,  # f32 master + Adam m/v is 12 B/param
    tput_floor_gbps: float = 5.0,
) -> ReshardPlan:
    """Price & schedule the state movement for old->new pod sets.

    With pure-DP over pods each pod holds a full replica, so a joining pod
    bootstraps from the cheapest-reachable existing pod; a leaving pod only
    requires quorum bookkeeping. (With fsdp_pod sharding the volume scales
    by old/new shard ratios instead — the planner call is identical.)"""
    n_params = cfg.param_count()
    replica_gb = n_params * bytes_per_param / 1e9
    joining = [r for r in pod_regions_new if r not in pod_regions_old]
    planner = Planner(top)
    moves = []
    total_cost = 0.0
    worst_time = 0.0
    for dst in joining:
        best = None
        for src in pod_regions_old:
            goal = min(tput_floor_gbps, planner.plan(PlanSpec(
                objective="max_throughput", src=src, dst=dst,
            )) * 0.9)
            if goal <= 0:
                continue
            plan = planner.plan(PlanSpec(
                objective="cost_min", src=src, dst=dst,
                tput_goal_gbps=goal, volume_gb=replica_gb,
            ))
            if best is None or plan.total_cost < best[0]:
                best = (plan.total_cost, src, plan)
        if best is None:
            raise ValueError(f"no source pod can reach joining pod {dst}")
        cost, src, plan = best
        moves.append((src, dst, replica_gb, plan.throughput, cost))
        total_cost += cost
        worst_time = max(worst_time, plan.transfer_time_s)
    return ReshardPlan(
        old_pods=len(pod_regions_old),
        new_pods=len(pod_regions_new),
        moves=moves,
        total_gb=replica_gb * len(joining),
        total_cost=total_cost,
        est_time_s=worst_time,
    )


def reshard_state(cfg, state_tree, *, new_pods: int, data: int = 16,
                  model: int = 16, rules: ShardingRules | None = None,
                  device=None):
    """Re-mesh: place an existing (params/opt) tree onto the new mesh's
    placements, every leaf a DTensor (``device=None``: a mesh on the card).
    Every rank of the new mesh calls it with the same tree. Returns
    (new_mesh, resharded_tree)."""
    from torch.distributed.tensor import distribute_tensor

    mesh = make_mesh_for(new_pods, data, model, device=device)
    rules = rules or ShardingRules()
    abstract = abstract_params(cfg)
    pshard = make_param_shardings(mesh, rules, abstract)

    def put(leaf, shd):
        return distribute_tensor(leaf.detach().to(mesh.device_type), mesh,
                                 shd.placements())

    new_params = tree_map(put, state_tree["params"], pshard)
    new_opt = {
        "m": tree_map(put, state_tree["opt"]["m"], pshard),
        "v": tree_map(put, state_tree["opt"]["v"], pshard),
        "step": state_tree["opt"]["step"],
    }
    return mesh, {"params": new_params, "opt": new_opt}
