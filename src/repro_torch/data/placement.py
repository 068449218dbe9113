"""Skyplane-planned dataset staging: which replica each consumer pulls a
shard from, and over which overlay route (paper technique -> input layer).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.planner import Planner
from repro_torch.core.spec import PlanSpec
from repro_torch.core.topology import Topology


@dataclasses.dataclass
class ShardSource:
    shard: int
    source_region: str
    plan_tput_gbps: float
    plan_cost_per_gb: float
    relay_regions: list


def plan_shard_sources(
    top: Topology,
    shard_replicas: dict[int, list[str]],
    consumer_region: str,
    *,
    shard_gb: float = 1.0,
    tput_floor_gbps: float = 2.0,
    max_relays: int = 6,
) -> list[ShardSource]:
    """For each shard, pick the replica + overlay route minimizing $/GB
    subject to a bandwidth floor (Skyplane cost-min mode per source)."""
    planner = Planner(top, max_relays=max_relays)
    out = []
    plan_cache: dict[str, tuple] = {}
    for shard, replicas in sorted(shard_replicas.items()):
        best = None
        for src in replicas:
            if src == consumer_region:
                best = (0.0, src, 1e9, [])
                break
            if src not in plan_cache:
                goal = min(
                    tput_floor_gbps,
                    planner.plan(PlanSpec(
                        objective="max_throughput", src=src,
                        dst=consumer_region,
                    )) * 0.9,
                )
                if goal <= 0:
                    continue
                plan = planner.plan(PlanSpec(
                    objective="cost_min", src=src, dst=consumer_region,
                    tput_goal_gbps=goal, volume_gb=shard_gb,
                ))
                relays = sorted(
                    {r for path, _ in plan.paths() for r in path[1:-1]}
                )
                plan_cache[src] = (
                    plan.cost_per_gb, plan.throughput,
                    [top.keys()[r] for r in relays],
                )
            cost, tput, relays = plan_cache[src]
            if best is None or cost < best[0]:
                best = (cost, src, tput, relays)
        if best is None:
            raise ValueError(f"no reachable replica for shard {shard}")
        cost, src, tput, relays = best
        out.append(ShardSource(shard, src, tput, cost, relays))
    return out
