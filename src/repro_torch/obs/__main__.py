"""Trace a seeded chaos scenario and export it.

    PYTHONPATH=src python -m repro_torch.obs [--seed N] [--out trace.json] [--text]

Plans two jobs on the default topology, compiles a seeded
``ChaosScenario`` against their routes, runs ``transfer.sim.simulate``
(the reference oracle with ``--sim ref``) with the tracer enabled, and writes
the Chrome-trace JSON — load it at https://ui.perfetto.dev or
``chrome://tracing``. The tracer is enabled AFTER planning, so the
exported trace contains only sim-time events and the same ``--seed``
produces byte-identical output across processes (pinned by
tests/test_obs.py).
"""

from __future__ import annotations

import argparse
import sys

from .export import text_timeline, trace_json
from .trace import disable, enable

SRC, DST = "aws:us-west-2", "aws:eu-central-1"
SRC2 = "gcp:us-central1"


def trace_chaos_scenario(
    seed: int = 0,
    *,
    volume_gb: float = 2.0,
    horizon_s: float = 12.0,
    capacity: int = 1 << 16,
    reference: bool = False,
) -> list:
    """Run the seeded chaos scenario under tracing; returns the events."""
    from repro_torch.core import Planner, PlanSpec, default_topology
    from repro_torch.transfer import ChaosScenario, TransferJob, simulate

    top = default_topology()
    planner = Planner(top, max_relays=6)
    s, d, s2 = top.index(SRC), top.index(DST), top.index(SRC2)
    jobs = [
        TransferJob(
            plan=planner.plan(PlanSpec(
                objective="cost_min", src=SRC, dst=DST,
                tput_goal_gbps=2.0, volume_gb=volume_gb,
            )),
            name="bulk-a", chunk_mb=64.0,
        ),
        TransferJob(
            plan=planner.plan(PlanSpec(
                objective="cost_min", src=SRC2, dst=DST,
                tput_goal_gbps=2.0, volume_gb=volume_gb,
            )),
            name="bulk-b", arrival_s=1.0, chunk_mb=64.0,
        ),
    ]
    sc = ChaosScenario(
        top, seed=seed, horizon_s=horizon_s * 0.5,
        n_brownouts=1, n_gray=1, n_flapping=1,
        links=[(s, d), (s2, d)],
    )
    engine = "ref" if reference else "soa"
    tr = enable(capacity=capacity)
    try:
        simulate(jobs, sc.events(len(jobs)), seed=seed,
                 horizon_s=horizon_s, drain=True, engine=engine)
        return tr.events()
    finally:
        disable()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description=__doc__.splitlines()[0]
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write Chrome-trace JSON here (default: stdout)")
    ap.add_argument("--text", action="store_true",
                    help="print a text timeline instead of JSON")
    ap.add_argument("--volume-gb", type=float, default=2.0)
    ap.add_argument("--horizon-s", type=float, default=12.0)
    ap.add_argument("--capacity", type=int, default=1 << 16,
                    help="trace ring-buffer capacity (events)")
    ap.add_argument("--sim", choices=("fast", "ref"), default="fast",
                    help="simulator: vectorized flowsim or the reference")
    args = ap.parse_args(argv)

    events = trace_chaos_scenario(
        args.seed, volume_gb=args.volume_gb, horizon_s=args.horizon_s,
        capacity=args.capacity, reference=args.sim == "ref",
    )
    if args.text:
        print(text_timeline(events))
        return 0
    payload = trace_json(events)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(payload)
            fh.write("\n")
        print(f"# {len(events)} events -> {args.out}", file=sys.stderr)
    else:
        print(payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
