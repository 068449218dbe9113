"""Carry planning and model state into the port.

For transfers the port is given a network and plans: a ``Topology`` (the
throughput, price and limit grids over named regions) and
``TransferPlan`` / ``MulticastPlan`` allocations on it, with the jobs and
scripted faults a simulation runs. For models it is given a parameter tree
and a decode state. This module moves them across as plain state: numpy
arrays, region keys and scalars.

``*_state`` functions read any object with the reference's attribute
names (the reference package's objects or the port's) and return plain
dictionaries; ``*_from_state`` functions build the port's objects from
them. A trainer's state (parameters, AdamW moments and step) and its
batches cross the same way. Nothing here imports the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.plan import MulticastPlan, TransferPlan
from .core.topology import Region, Topology
from .device import resolve_device
from .transfer import events

_GRIDS = ("tput", "price_egress", "price_vm", "limit_ingress", "limit_egress")
_FAULTS = {
    cls.__name__: cls
    for cls in (events.LinkDegrade, events.GrayFailure, events.LinkRestore,
                events.VMFailure)
}


def topology_state(top) -> dict:
    """Grids as float64 arrays, regions as keys plus their continent and
    coordinates, and the two service limits."""
    st = {k: np.array(getattr(top, k), dtype=np.float64) for k in _GRIDS}
    st["rtt_ms"] = (
        None if top.rtt_ms is None
        else np.array(top.rtt_ms, dtype=np.float64)
    )
    st["region_keys"] = [r.key for r in top.regions]
    st["region_continent"] = [r.continent for r in top.regions]
    st["region_latlon"] = np.array(
        [[r.lat, r.lon] for r in top.regions], dtype=np.float64
    ).reshape(-1, 2)
    st["limit_conn"] = int(top.limit_conn)
    st["limit_vm"] = int(top.limit_vm)
    return st


def topology_from_state(st: dict) -> Topology:
    regions = []
    for key, cont, (lat, lon) in zip(
        st["region_keys"], st["region_continent"], st["region_latlon"]
    ):
        provider, name = key.split(":", 1)
        regions.append(Region(provider, name, cont, float(lat), float(lon)))
    return Topology(
        regions=regions,
        **{k: np.array(st[k], dtype=np.float64) for k in _GRIDS},
        rtt_ms=None if st["rtt_ms"] is None else np.array(st["rtt_ms"]),
        limit_conn=st["limit_conn"],
        limit_vm=st["limit_vm"],
    )


def plan_state(plan) -> dict:
    """A unicast or multicast plan's allocation and request, without its
    topology (carried once with ``topology_state``)."""
    st = {
        "src": int(plan.src),
        "volume_gb": float(plan.volume_gb),
        "N": np.array(plan.N, dtype=np.float64),
        "M": np.array(plan.M, dtype=np.float64),
        "F": np.array(plan.F, dtype=np.float64),
        "solver_status": str(plan.solver_status),
    }
    if hasattr(plan, "dsts"):
        st.update(
            kind="multicast", dsts=[int(d) for d in plan.dsts],
            tput_goals=np.array(plan.tput_goals, dtype=np.float64),
            G=np.array(plan.G, dtype=np.float64),
        )
    else:
        st.update(kind="unicast", dst=int(plan.dst),
                  tput_goal=float(plan.tput_goal))
    return st


def plan_from_state(st: dict, top: Topology):
    common = dict(
        top=top, src=st["src"], volume_gb=st["volume_gb"],
        F=np.array(st["F"]), N=np.array(st["N"]), M=np.array(st["M"]),
        solver_status=st["solver_status"],
    )
    if st["kind"] == "multicast":
        return MulticastPlan(
            dsts=list(st["dsts"]), tput_goals=np.array(st["tput_goals"]),
            G=np.array(st["G"]), **common,
        )
    return TransferPlan(dst=st["dst"], tput_goal=st["tput_goal"], **common)


def to_port_topology(top) -> Topology:
    return topology_from_state(topology_state(top))


def to_port_plan(plan, top: Topology | None = None):
    """``plan`` as the port's plan object, on ``top`` (default: its own
    topology carried across)."""
    if top is None:
        top = to_port_topology(plan.top)
    return plan_from_state(plan_state(plan), top)


def to_port_jobs(jobs) -> list:
    """``TransferJob``s carried across; jobs whose plans share one
    topology object share one converted topology."""
    tops: dict[int, Topology] = {}
    out = []
    for job in jobs:
        key = id(job.plan.top)
        if key not in tops:
            tops[key] = to_port_topology(job.plan.top)
        out.append(events.TransferJob(
            plan=to_port_plan(job.plan, tops[key]), name=str(job.name),
            arrival_s=float(job.arrival_s), chunk_mb=float(job.chunk_mb),
        ))
    return out


def to_port_faults(faults) -> list:
    """Scripted fault events carried across by class name and fields."""
    out = []
    for f in faults:
        cls = _FAULTS[type(f).__name__]
        fields = cls.__dataclass_fields__
        out.append(cls(**{k: getattr(f, k) for k in fields}))
    return out


# ------------------------------------------------------------ model state
def params_state(tree) -> dict:
    """A parameter tree or a decode state (nested dicts of arrays, the
    reference's pytree or the port's) flattened to numpy arrays under
    dotted keys such as ``"decoder.ssm_blocks.ssm.in_proj"``. The port
    keeps the reference's layouts (``wq`` [D,H,Dh], stacked [groups, per,
    ...] leaves), so the conversion is leaf for leaf, with no
    transposes."""
    out: dict = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}.{k}" if prefix else k)
        elif isinstance(t, torch.Tensor):
            out[prefix] = (t.detach().float().cpu().numpy()
                           if t.dtype == torch.bfloat16
                           else t.detach().cpu().numpy())
        else:
            out[prefix] = np.asarray(t)
    walk(tree, "")
    return out


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> a torch copy on ``device`` (never a view: the port updates
    decode caches in place, and the array may be another framework's
    buffer); bfloat16 (ml_dtypes) through float32, which holds every
    bfloat16 value exactly."""
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device,
                            dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_state(state: dict, device=None) -> dict:
    """The port's parameter tree from ``params_state`` output, on
    ``device`` (the card unless the caller names another)."""
    device = resolve_device(device)
    tree: dict = {}
    for key, a in state.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = _tensor(np.asarray(a), device)
    return tree


def decode_state_from_state(st: dict, device=None) -> dict:
    """The port's decode state from ``params_state`` of a decode state:
    caches as tensors, ``pos`` a 0-d int32 tensor."""
    state = params_from_state(st, device)
    state["pos"] = state["pos"].to(torch.int32).reshape(())
    return state


def opt_state_from_state(st: dict, device=None) -> dict:
    """The port's AdamW state ({"m", "v", "step"}) from ``params_state``
    of an optimizer state: moments as tensors, ``step`` a 0-d int32
    tensor."""
    state = params_from_state(st, device)
    state["step"] = state["step"].to(torch.int32).reshape(())
    return state


def batch_from_numpy(batch: dict, device=None) -> dict:
    """A pipeline batch (numpy arrays: tokens, labels) as tensors on
    ``device`` (the card unless the caller names another)."""
    device = resolve_device(device)
    return {k: _tensor(np.asarray(v), device) for k, v in batch.items()}
