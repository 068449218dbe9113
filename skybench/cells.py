"""Cells, configurations, traffic mixes and the inputs built from them.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
The configuration (``configs/<name>.json``) is a deployment: routes, VMs
a region, TCP connections a VM, chunk size, the jobs a sim holds and the
sim's knobs. The traffic mix (``traffic/<name>.json``) is data that the
one generator here reads: chunks a job, arrival spacing, the closed
loop's callers, the pool of sim seeds, and the horizons of the slices
that warm up and are profiled.

The inputs are made with the frozen reference (``reference/``): its
embedded grids give the topology and its ``direct_plan`` the plans. The
program gets the same arrays as its own ``TransferJob``/``TransferPlan``
objects (``to_program``); the reference gets them as they are.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Iterator

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix and per-layer metric names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    per_layer: tuple  # the per-layer metric names reported in this cell
    end_to_end: tuple  # the end-to-end metric names reported in this cell
    units: dict  # every metric's unit, by name


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of the manifest, its files read by name."""
    m = manifest()
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the manifest has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in m["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    mix = w["traffic"]
    traffic = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    if traffic.get("loop") != "closed" or traffic.get("callers") != 1:
        raise ValueError(f"traffic {mix!r}: the harness drives a closed "
                         f"loop of one caller")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        per_layer=tuple(x["name"] for x in m["per_layer"]
                        if _reports(x, name)),
        end_to_end=tuple(x["name"] for x in m["end_to_end"]
                         if _reports(x, name)),
        units={x["name"]: x["unit"]
               for x in m["end_to_end"] + m["per_layer"]},
    )


def metric_reader(name: str):
    """The module ``metrics/<name>.py``: its ``read(readings)`` returns
    the metric's value, or None where it finds nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"skybench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------- traffic
@dataclasses.dataclass(frozen=True)
class JobSpec:
    name: str
    src: str
    dst: str
    vms: int
    chunks: int
    chunk_mb: float
    arrival_s: float


def job_specs(config: dict, traffic: dict) -> list[JobSpec]:
    """Every sim's jobs: ``config["jobs"]`` of them, cycling over the
    configuration's routes, job ``i`` arriving at ``i * arrival_gap_s``."""
    routes = config["routes"]
    return [
        JobSpec(
            name=f"job{i}", src=routes[i % len(routes)][0],
            dst=routes[i % len(routes)][1], vms=int(config["vms_per_region"]),
            chunks=int(traffic["chunks_per_job"]),
            chunk_mb=float(config["chunk_mb"]),
            arrival_s=float(traffic.get("arrival_gap_s", 0.0)) * i,
        )
        for i in range(int(config["jobs"]))
    ]


def sim_seeds(seed: int, pool: list) -> Iterator[int]:
    """The closed loop's sim seeds, one a sim, from the run's ``--seed``
    (any whole number): the traffic's ``sim_seed_pool`` in an order drawn
    from it, cycled, so every run does the same set of sims."""
    rng = np.random.default_rng(int(seed) % 2**64)
    order = [int(pool[i]) for i in rng.permutation(len(pool))]
    while True:
        yield from order


def sim_knobs(config: dict) -> dict:
    """The configuration's ``SimConfig`` knobs as keyword arguments."""
    s = config["sim"]
    return dict(
        link_capacity_scale=s["link_capacity_scale"],
        straggler_prob=float(s["straggler_prob"]),
        straggler_speed=tuple(float(x) for x in s["straggler_speed"]),
        relay_buffer_chunks=int(s["relay_buffer_chunks"]),
    )


# ------------------------------------------------------------ the inputs
@dataclasses.dataclass
class Inputs:
    """A cell's jobs, on the reference's side and the program's, built
    from the same arrays."""

    ref_jobs: list
    jobs: list  # the program's TransferJob objects
    knobs: dict


def reference_jobs(config: dict, traffic: dict) -> list:
    """The jobs as the frozen reference's objects."""
    from skybench.reference.core.baselines import direct_plan
    from skybench.reference.core.profiles import default_topology
    from skybench.reference.transfer import events

    top = dataclasses.replace(default_topology(),
                              limit_conn=int(config["connections_per_vm"]))
    specs = job_specs(config, traffic)
    if any(s.vms > top.limit_vm for s in specs):
        raise ValueError(f"more VMs a region than the topology's service "
                         f"limit of {top.limit_vm}")
    return [
        events.TransferJob(
            direct_plan(top, s.src, s.dst, s.chunks * s.chunk_mb / 1024,
                        num_vms=s.vms),
            s.name, arrival_s=s.arrival_s, chunk_mb=s.chunk_mb)
        for s in specs
    ]


def to_program(ref_jobs: list) -> list:
    """The same jobs as the program's objects: its ``Topology``,
    ``TransferPlan`` and ``TransferJob``, holding copies of the
    reference's arrays."""
    from repro_torch.core.plan import TransferPlan
    from repro_torch.core.topology import Region, Topology
    from repro_torch.transfer import events

    rt = ref_jobs[0].plan.top
    top = Topology(
        regions=[Region(r.provider, r.name, r.continent, r.lat, r.lon)
                 for r in rt.regions],
        tput=np.array(rt.tput), price_egress=np.array(rt.price_egress),
        price_vm=np.array(rt.price_vm),
        limit_ingress=np.array(rt.limit_ingress),
        limit_egress=np.array(rt.limit_egress),
        rtt_ms=None if rt.rtt_ms is None else np.array(rt.rtt_ms),
        limit_conn=rt.limit_conn, limit_vm=rt.limit_vm,
    )
    jobs = []
    for j in ref_jobs:
        p = j.plan
        plan = TransferPlan(
            top=top, src=p.src, dst=p.dst, tput_goal=p.tput_goal,
            volume_gb=p.volume_gb, F=np.array(p.F), N=np.array(p.N),
            M=np.array(p.M), solver_status=p.solver_status)
        jobs.append(events.TransferJob(plan, j.name, arrival_s=j.arrival_s,
                                       chunk_mb=j.chunk_mb))
    return jobs


def build_inputs(cell: Cell) -> Inputs:
    ref_jobs = reference_jobs(cell.config, cell.traffic)
    return Inputs(ref_jobs, to_program(ref_jobs), sim_knobs(cell.config))
