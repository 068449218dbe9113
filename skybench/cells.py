"""Cells, configurations, traffic mixes and the inputs built from them.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
The configuration (``configs/<name>.json``) is a deployment: its jobs'
plans, TCP connections a VM, chunk size, the jobs a sim holds and the
sim's knobs. The plans are given one of two ways, never both: ``routes``,
each a direct plan of ``vms_per_region`` VMs at both ends, or ``plans``,
each a plan frozen as data (``freeze_plan.py`` writes one): a unicast or
multicast plan's VMs, connections and flows by region name. The traffic
mix (``traffic/<name>.json``) is data that the one generator here reads:
chunks a job, arrival spacing, the closed loop's callers, the pool of sim
seeds, and the horizons of the slices that warm up and are profiled.

The inputs are made with the frozen reference (``reference/``): its
embedded grids give the topology, its ``direct_plan`` a route's plan, and
its ``TransferPlan``/``MulticastPlan`` hold a frozen plan, which its
``validate`` checks before any sim. The program gets the same arrays as
its own objects (``to_program``); the reference gets them as they are.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
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
    """One job of a sim: a route's direct plan (``route``, ``vms``) or a
    frozen plan (``plan``), its chunks and its arrival."""

    name: str
    chunks: int
    chunk_mb: float
    arrival_s: float
    route: tuple | None = None  # (src, dst) region names
    vms: int | None = None  # VMs a region of the route's direct plan
    plan: int | None = None  # the index of its entry in ``plans``


def job_specs(config: dict, traffic: dict) -> list[JobSpec]:
    """Every sim's jobs: ``config["jobs"]`` of them, cycling over the
    configuration's routes or plans, job ``i`` arriving at
    ``i * arrival_gap_s``."""
    given = [k for k in ("routes", "plans") if k in config]
    if len(given) != 1 or not config[given[0]]:
        raise ValueError(
            f"configuration {config.get('name')!r}: give a non-empty "
            f"'routes' or 'plans', one of them; it gives {given or 'neither'}")
    each = config[given[0]]
    specs = []
    for i in range(int(config["jobs"])):
        k = i % len(each)
        how = (dict(route=(each[k][0], each[k][1]),
                    vms=int(config["vms_per_region"]))
               if given == ["routes"] else dict(plan=k))
        specs.append(JobSpec(
            name=f"job{i}", chunks=int(traffic["chunks_per_job"]),
            chunk_mb=float(config["chunk_mb"]),
            arrival_s=float(traffic.get("arrival_gap_s", 0.0)) * i, **how))
    return specs


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
    """The jobs as the frozen reference's objects. A frozen plan is
    loaded and checked once, before any sim, and scoped to each job's
    volume (``chunks * chunk_mb / 1024`` GB, to each destination of a
    multicast) by ``with_volume``."""
    from skybench.reference.core.baselines import direct_plan
    from skybench.reference.core.profiles import default_topology
    from skybench.reference.transfer import events

    top = dataclasses.replace(default_topology(),
                              limit_conn=int(config["connections_per_vm"]))
    specs = job_specs(config, traffic)
    if any(s.vms is not None and s.vms > top.limit_vm for s in specs):
        raise ValueError(f"more VMs a region than the topology's service "
                         f"limit of {top.limit_vm}")
    plans = [load_plan(top, e, where=f"{config.get('name')!r} plans[{k}]")
             for k, e in enumerate(config.get("plans", ()))]
    jobs = []
    for s in specs:
        volume_gb = s.chunks * s.chunk_mb / 1024
        plan = (direct_plan(top, *s.route, volume_gb, num_vms=s.vms)
                if s.plan is None else plans[s.plan].with_volume(volume_gb))
        jobs.append(events.TransferJob(plan, s.name, arrival_s=s.arrival_s,
                                       chunk_mb=s.chunk_mb))
    return jobs


# the keys of a frozen plan entry, by kind
PLAN_KEYS = {
    "unicast": {"kind", "src", "dst", "N", "M", "F", "tput_goal",
                "solver_status", "made_by"},
    "multicast": {"kind", "src", "dsts", "N", "M", "G", "F", "tput_goals",
                  "solver_status", "made_by"},
}


def load_plan(top, entry: dict, where: str = "plan"):
    """A frozen plan entry as the reference's ``TransferPlan`` or
    ``MulticastPlan`` on ``top``, at volume 0. Refuses, with a
    ``ValueError``, an entry of another shape, a name that is not a
    region of ``top``, a region with more VMs than ``top.limit_vm``, a
    value that is not a finite number, an edge given twice, and a plan
    that ``validate`` faults."""
    from skybench.reference.core.plan import MulticastPlan, TransferPlan

    def fail(why):
        raise ValueError(f"{where}: {why}")

    kind = entry.get("kind") if isinstance(entry, dict) else None
    if kind not in PLAN_KEYS:
        fail(f"'kind' is {kind!r}, not one of {sorted(PLAN_KEYS)}")
    if set(entry) != PLAN_KEYS[kind]:
        fail(f"a {kind} plan has the keys {sorted(PLAN_KEYS[kind])}, "
             f"not {sorted(entry)}")
    v, names = top.num_regions, set(top.keys())

    def region(name) -> int:
        if not isinstance(name, str) or name not in names:
            fail(f"{name!r} is not a region of the topology")
        return top.index(name)

    def number(x) -> float:
        if isinstance(x, bool) or not isinstance(x, (int, float)) or (
                not math.isfinite(x)):
            fail(f"{x!r} is not a finite number")
        return float(x)

    def grid(triples, what) -> np.ndarray:
        if not isinstance(triples, list):
            fail(f"{what} is a list of [src, dst, value]")
        g = np.zeros((v, v))
        seen = set()
        for t in triples:
            if not isinstance(t, list) or len(t) != 3:
                fail(f"{what}: {t!r} is not [src, dst, value]")
            a, b = region(t[0]), region(t[1])
            if (a, b) in seen:
                fail(f"{what}: {t[0]} -> {t[1]} is given twice")
            seen.add((a, b))
            g[a, b] = number(t[2])
        return g

    if not isinstance(entry["N"], dict):
        fail("'N' maps a region to its VMs")
    N = np.zeros(v)
    for name, n in entry["N"].items():
        r = region(name)
        N[r] = number(n)
        if N[r] > top.limit_vm:
            fail(f"{name} holds {n} VMs, more than the topology's service "
                 f"limit of {top.limit_vm}")
    src, M = region(entry["src"]), grid(entry["M"], "M")
    status = str(entry["solver_status"])
    if not isinstance(entry["made_by"], dict) or not {
            "spec", "commit"} <= set(entry["made_by"]):
        fail("'made_by' names the spec and the commit that made the plan")
    if kind == "unicast":
        if region(entry["dst"]) == src:
            fail("'dst' is a region other than the source")
        plan = TransferPlan(
            top=top, src=src, dst=region(entry["dst"]),
            tput_goal=number(entry["tput_goal"]), volume_gb=0.0,
            F=grid(entry["F"], "F"), N=N, M=M, solver_status=status)
    else:
        dsts = [region(d) for d in entry["dsts"]]
        if not isinstance(entry["F"], dict) or not isinstance(
                entry["tput_goals"], list):
            fail("'F' maps each destination to its flows, 'tput_goals' "
                 "lists their goals")
        if not dsts or len(set(dsts)) != len(dsts) or src in dsts:
            fail("'dsts' are distinct regions other than the source")
        if set(entry["F"]) != set(entry["dsts"]) or len(
                entry["tput_goals"]) != len(dsts):
            fail("'F' and 'tput_goals' have one entry for each destination")
        plan = MulticastPlan(
            top=top, src=src, dsts=dsts,
            tput_goals=np.array([number(g) for g in entry["tput_goals"]]),
            volume_gb=0.0, G=grid(entry["G"], "G"),
            F=np.stack([grid(entry["F"][d], f"F[{d}]")
                        for d in entry["dsts"]]),
            N=N, M=M, solver_status=status)
    errs = plan.validate()
    if errs:
        fail(f"the plan does not validate: {errs}")
    return plan


def to_program(ref_jobs: list) -> list:
    """The same jobs as the program's objects: its ``Topology``,
    ``TransferPlan`` or ``MulticastPlan``, and ``TransferJob``, holding
    copies of the reference's arrays."""
    from repro_torch.core.plan import MulticastPlan, TransferPlan
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
        if hasattr(p, "dsts"):
            plan = MulticastPlan(
                top=top, src=p.src, dsts=list(p.dsts),
                tput_goals=np.array(p.tput_goals), volume_gb=p.volume_gb,
                G=np.array(p.G), F=np.array(p.F), N=np.array(p.N),
                M=np.array(p.M), solver_status=p.solver_status)
        else:
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
