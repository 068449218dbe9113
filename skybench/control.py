"""The control of ``correct``: the program's own lower precision.

The configurations state float64, and the program has its own float32
water-filling (``simulate_multi_torch(..., rate_solver="f32")``, the
counterpart of the TPU kernel's). This script runs ``--seeds`` sims of
the cell, with the sim seeds a run at ``--seed`` would take, each twice
on the card, as the timed path does and with the float32 solver, and
holds both against the frozen reference, printing each reading. The
program's readings are the lower ones of ``judge.LIMITS``; the
control's, which have to fail them, the upper ones. The benchmark's own
runs never run this.

    python3 skybench/control.py --workload <cell> --seed <n> --seeds 12
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, n_seeds: int, *, device: str = "cuda",
             out=None) -> list[dict]:
    """One dict a sim: its sim seed, the program's reading
    (``program``) and the control's (``control``), each with its wall
    seconds."""
    import torch

    from repro_torch.transfer import simulate
    from repro_torch.transfer.flowsim_torch import simulate_multi_torch
    from skybench import cells, judge
    from skybench.reference.transfer import flowsim

    inputs = cells.build_inputs(cell)
    if device == "cuda":
        from repro_torch.kernels.waterfill import build

        build.load()

    def timed(fn):
        t = time.perf_counter()
        res = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return res, time.perf_counter() - t

    rows = []
    seeds = cells.sim_seeds(seed, cell.traffic["sim_seed_pool"])
    for _ in range(n_seeds):
        s = next(seeds)
        prog, prog_s = timed(lambda: simulate(
            inputs.jobs, (), engine="torch", device=device,
            seed=s, **inputs.knobs))
        ctrl, ctrl_s = timed(lambda: simulate_multi_torch(
            inputs.jobs, (), device=device, seed=s,
            rate_solver="f32", **inputs.knobs))
        ref = flowsim._simulate_multi_impl(
            inputs.ref_jobs, (), seed=s, **inputs.knobs)
        row = {"sim_seed": s,
               "program": {**judge.compare(prog, ref), "wall_s": prog_s},
               "control": {**judge.compare(ctrl, ref), "wall_s": ctrl_s}}
        rows.append(row)
        if out is not None:
            print(json.dumps(row), file=out, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    args = ap.parse_args(argv)
    import torch

    from skybench import cells, harness, judge

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    rows = readings(cell, args.seed, args.seeds, out=sys.stdout)
    summary = {"workload": cell.name, "card": harness.card_line(),
               "seeds": len(rows)}
    for k in judge.LIMITS:
        summary[f"program_{k}_max"] = max(r["program"][k] for r in rows)
        summary[f"control_{k}_min"] = min(r["control"][k] for r in rows)
    summary["control_fails_every_seed"] = all(
        not judge.within(r["control"]) for r in rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root (for ``skybench``) and ``src`` (for the
    # program), in place of this script's own directory
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
