"""Cross-region checkpoint replication — the framework's verbatim Skyplane
job. After a checkpoint commits, its files are bulk-transferred from the
training region's object store to the disaster-recovery regions through ONE
multicast overlay: the planner builds distribution trees whose
shared hops are billed once, instead of paying source egress per DR region,
and the real-bytes gateway fans chunks out at the relays with per-
destination checksum verification.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from repro_torch.core.plan import MulticastPlan
from repro_torch.core.planner import Planner
from repro_torch.core.spec import PlanSpec
from repro_torch.core.topology import Topology
from repro_torch.transfer.gateway import (
    DirStore,
    GatewayReport,
    MulticastGatewayReport,
    ObjectStore,
    transfer_objects_multicast,
)
from repro_torch.transfer.reports import Report


@dataclasses.dataclass
class ReplicationReport(Report):
    """Per-destination view of one multicast replication.

    ``plan_cost`` / ``plan_cost_per_gb`` are the cost of the WHOLE
    one-to-many transfer (shared hops are billed once, so per-destination
    cost is not separable); ``plan_tput_gbps`` is this destination's
    planned delivery rate."""

    destination: str
    plan_tput_gbps: float
    plan_cost: float
    plan_cost_per_gb: float
    relay_regions: list
    gateway: GatewayReport

    kind = "replication"
    _summary_keys = ("destination", "plan_tput_gbps", "plan_cost_per_gb",
                     "relays")

    def _payload(self) -> dict:
        return {
            "destination": self.destination,
            "plan_tput_gbps": self.plan_tput_gbps,
            "plan_cost": self.plan_cost,
            "plan_cost_per_gb": self.plan_cost_per_gb,
            "relays": len(self.relay_regions),
            "relay_regions": list(self.relay_regions),
            "gateway": self.gateway.to_dict(),
        }


def replicate_checkpoint(
    ckpt_path: str | Path,
    top: Topology,
    src_region: str,
    dst_regions: list[str],
    dst_stores: dict[str, ObjectStore],
    *,
    cost_ceiling_per_gb: float | None = None,
    tput_floor_gbps: float | None = None,
    max_relays: int = 8,
    volume_gb: float | None = None,
) -> list[ReplicationReport]:
    """Replicate all files of a committed checkpoint to every DR region
    through one multicast transfer.

    At most one of ``cost_ceiling_per_gb`` / ``tput_floor_gbps`` selects the
    planner mode (paper §4: tput-max under a cost ceiling, or cost-min under
    a per-destination tput floor); passing both raises — silently ignoring
    the floor would hand back a plan violating the caller's SLO. With
    neither, cost-min at half the max achievable uniform rate. Every entry
    of ``dst_regions`` must have a store in ``dst_stores`` — checked before
    any planning or byte movement."""
    if cost_ceiling_per_gb is not None and tput_floor_gbps is not None:
        raise ValueError(
            "pass at most one of cost_ceiling_per_gb / tput_floor_gbps "
            "(they select mutually exclusive planner modes)"
        )
    missing = [d for d in dst_regions if d not in dst_stores]
    if missing:
        raise ValueError(f"dst_regions missing from dst_stores: {missing}")
    if not dst_regions:
        raise ValueError("no destination regions")

    ckpt_path = Path(ckpt_path)
    src_store = DirStore(ckpt_path)
    keys = src_store.keys()
    if volume_gb is None:
        volume_gb = sum(src_store.size(k) for k in keys) / 1e9
    planner = Planner(top, max_relays=max_relays)

    if cost_ceiling_per_gb is not None:
        plan = planner.plan(PlanSpec(
            objective="tput_max", src=src_region, dsts=tuple(dst_regions),
            cost_ceiling_per_gb=cost_ceiling_per_gb, volume_gb=volume_gb,
        ))
    else:
        goal = tput_floor_gbps or planner.plan(PlanSpec(
            objective="max_throughput", src=src_region,
            dsts=tuple(dst_regions),
        )) * 0.5
        plan = planner.plan(PlanSpec(
            objective="cost_min", src=src_region, dsts=tuple(dst_regions),
            tput_goal_gbps=goal, volume_gb=volume_gb,
        ))

    gw = transfer_objects_multicast(
        plan, src_store, dst_stores, keys
    )
    return reports_from(plan, gw, dst_regions, top)


def reports_from(
    plan: MulticastPlan,
    gw: MulticastGatewayReport,
    dst_regions: list[str],
    top: Topology,
) -> list[ReplicationReport]:
    """Per-destination ReplicationReports for a finished multicast run."""
    reports = []
    for dst in dst_regions:
        d = top.index(dst)
        relays = sorted(
            {r for path, _ in plan.paths_to(d) for r in path[1:-1]}
        )
        reports.append(
            ReplicationReport(
                destination=dst,
                plan_tput_gbps=plan.delivered_gbps(d),
                plan_cost=plan.total_cost,
                plan_cost_per_gb=plan.cost_per_gb,
                relay_regions=[top.keys()[r] for r in relays],
                gateway=gw.per_dest[dst],
            )
        )
    return reports
