"""Freeze a plan of the program's planner as data, for a configuration's
``plans`` (``cells.load_plan`` reads it back).

    python3 skybench/freeze_plan.py --objective cost_min \\
        --src gcp:us-east1 --dsts gcp:europe-west4,gcp:europe-west6 \\
        --tput-goal-gbps 10 --volume-gb 123 [--connections-per-vm 64]

runs the program's numpy planner on the CPU over its default topology
(with ``--connections-per-vm`` TCP connections a VM), and prints one
``plans`` entry as JSON: the kind, the source and destinations, the VMs
``N`` by region, the connections ``M`` and flows ``F`` (and a multicast's
envelope ``G``, its ``F`` by destination) as ``[src, dst, value]`` lists
of the non-zero cells by region name, the goals, the solver's status, and
``made_by``: the ``PlanSpec``, the connections a VM and the commit. A
float's ``repr`` survives JSON, so the entry loads back to the planner's
arrays bit for bit. The benchmark's runs never import this file: a cell
runs the plan as frozen, whatever a later planner would make.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _triples(keys, g) -> list:
    """The cells of ``g`` that are not +0.0, as [src, dst, value]."""
    hit = np.argwhere((g != 0) | np.signbit(g))
    return [[keys[a], keys[b], float(g[a, b])] for a, b in hit]


def plan_entry(plan, made_by: dict) -> dict:
    """A program ``TransferPlan`` or ``MulticastPlan`` as a ``plans``
    entry."""
    keys = plan.top.keys()
    entry = {"src": keys[plan.src]}
    if hasattr(plan, "dsts"):
        entry = {
            "kind": "multicast", **entry,
            "dsts": [keys[d] for d in plan.dsts],
            "tput_goals": [float(g) for g in plan.tput_goals],
            "G": _triples(keys, plan.G),
            "F": {keys[d]: _triples(keys, plan.F[k])
                  for k, d in enumerate(plan.dsts)},
        }
    else:
        entry = {"kind": "unicast", **entry, "dst": keys[plan.dst],
                 "tput_goal": float(plan.tput_goal),
                 "F": _triples(keys, plan.F)}
    hit = np.flatnonzero((plan.N != 0) | np.signbit(plan.N))
    entry.update(N={keys[r]: float(plan.N[r]) for r in hit},
                 M=_triples(keys, plan.M),
                 solver_status=str(plan.solver_status), made_by=made_by)
    return entry


def freeze(spec, connections_per_vm: int, commit: str) -> dict:
    """Plan ``spec`` (a program ``PlanSpec``, objective ``cost_min`` or
    ``tput_max``) and return its ``plans`` entry."""
    from repro_torch.core import Planner, default_topology

    if spec.objective not in ("cost_min", "tput_max"):
        raise ValueError(f"objective {spec.objective!r} makes no plan; "
                         f"use cost_min or tput_max")
    top = dataclasses.replace(default_topology(),
                              limit_conn=int(connections_per_vm))
    plan = Planner(top).plan(spec)
    given = {k: list(v) if isinstance(v, tuple) else v
             for k, v in dataclasses.asdict(spec).items() if v is not None}
    return plan_entry(plan, {"spec": given,
                             "connections_per_vm": int(connections_per_vm),
                             "commit": commit})


def _head() -> str:
    out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--objective", required=True,
                    choices=("cost_min", "tput_max"))
    ap.add_argument("--src", required=True)
    to = ap.add_mutually_exclusive_group(required=True)
    to.add_argument("--dst")
    to.add_argument("--dsts", help="comma-separated regions: a multicast")
    ap.add_argument("--volume-gb", type=float, required=True)
    ap.add_argument("--tput-goal-gbps", type=float, default=0.0)
    ap.add_argument("--cost-ceiling-per-gb", type=float)
    ap.add_argument("--n-samples", type=int)
    ap.add_argument("--mode", choices=("relaxed", "exact"))
    ap.add_argument("--connections-per-vm", type=int, default=64)
    ap.add_argument("--commit", help="default: the checkout's git HEAD")
    args = ap.parse_args(argv)
    from repro_torch.core import PlanSpec

    spec = PlanSpec(
        objective=args.objective, src=args.src, dst=args.dst,
        dsts=None if args.dsts is None else tuple(args.dsts.split(",")),
        volume_gb=args.volume_gb, tput_goal_gbps=args.tput_goal_gbps,
        cost_ceiling_per_gb=args.cost_ceiling_per_gb,
        n_samples=args.n_samples, mode=args.mode)
    entry = freeze(spec, args.connections_per_vm, args.commit or _head())
    print(json.dumps(entry))
    return 0


if __name__ == "__main__":
    # the checkout's root and ``src`` (for the program), in place of this
    # script's own directory
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
