"""Skyplane-style planner CLI.

    PYTHONPATH=src python -m repro_torch.launch.plan \
        --src azure:canadacentral --dst gcp:asia-northeast1 \
        --volume-gb 50 [--cost-ceiling-x 1.25 | --tput-floor 20] [--simulate]
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core import Planner, PlanSpec, default_topology, direct_plan


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="e.g. aws:us-east-1")
    ap.add_argument("--dst", required=True)
    ap.add_argument("--volume-gb", type=float, default=50.0)
    ap.add_argument("--cost-ceiling-x", type=float, default=None,
                    help="price ceiling as a multiple of the direct path")
    ap.add_argument("--tput-floor", type=float, default=None,
                    help="Gbit/s floor for cost-min mode")
    ap.add_argument("--max-relays", type=int, default=10)
    ap.add_argument("--simulate", action="store_true",
                    help="execute on the fluid data-plane simulator")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    top = default_topology()
    planner = Planner(top, max_relays=args.max_relays)
    dp = direct_plan(top, args.src, args.dst, args.volume_gb)

    if args.tput_floor is not None:
        plan = planner.plan(PlanSpec(
            objective="cost_min", src=args.src, dst=args.dst,
            tput_goal_gbps=args.tput_floor, volume_gb=args.volume_gb,
        ))
    else:
        mult = args.cost_ceiling_x or 1.25
        plan = planner.plan(PlanSpec(
            objective="tput_max", src=args.src, dst=args.dst,
            cost_ceiling_per_gb=dp.cost_per_gb * mult,
            volume_gb=args.volume_gb,
        ))

    info = {
        "direct_gbps": round(dp.throughput, 2),
        "direct_cost_per_gb": round(dp.cost_per_gb, 4),
        "plan_gbps": round(plan.throughput, 2),
        "plan_cost_per_gb": round(plan.cost_per_gb, 4),
        "speedup": round(plan.throughput / max(dp.throughput, 1e-9), 2),
        "cost_x": round(plan.cost_per_gb / max(dp.cost_per_gb, 1e-9), 2),
        "vms": int(plan.num_vms),
        "paths": [
            {"route": [top.keys()[r] for r in path], "gbps": round(f, 2)}
            for path, f in plan.paths()
        ],
        "violations": plan.validate(),
    }
    if args.simulate:
        from repro_torch.transfer import execute_plan

        rep = execute_plan(plan, chunk_mb=16, seed=0)
        info["simulated_gbps"] = round(rep.sim.tput_gbps, 2)
        info["simulated_cost"] = round(rep.sim.total_cost, 2)
    if args.json:
        print(json.dumps(info, indent=2))
    else:
        print(plan.describe())
        for k, v in info.items():
            if k != "paths":
                print(f"  {k}: {v}")
    return 0 if not info["violations"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
