"""Skyplane's contribution: cost/throughput-optimal overlay planning (paper §4-§5)."""

from .topology import Region, Topology, GBIT_PER_GB  # noqa: F401
from .profiles import default_topology, grid_fingerprint, toy_topology  # noqa: F401
from .plan import McTree, MulticastPlan, TransferPlan  # noqa: F401
from .spec import PlanSpec  # noqa: F401
from .planner import Planner, ParetoPoint  # noqa: F401
from .baselines import (  # noqa: F401
    AWS_DATASYNC,
    AZURE_AZCOPY,
    GCP_STORAGE_TRANSFER,
    CloudServiceModel,
    direct_plan,
    gridftp_plan,
)

__all__ = [
    "AWS_DATASYNC",
    "AZURE_AZCOPY",
    "GBIT_PER_GB",
    "GCP_STORAGE_TRANSFER",
    "CloudServiceModel",
    "McTree",
    "MulticastPlan",
    "ParetoPoint",
    "PlanSpec",
    "Planner",
    "Region",
    "Topology",
    "TransferPlan",
    "default_topology",
    "direct_plan",
    "grid_fingerprint",
    "gridftp_plan",
    "toy_topology",
]
