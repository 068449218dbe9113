"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python3 skybench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints the result as one JSON object, the
last line of standard output, with the numbers compared beside their
limits as the last lines of standard error. Exits non-zero, printing no
result, without a CUDA card (or fewer than the cell asks for), and where
JAX or the JAX package was loaded in this process.
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from skybench import cells, harness

    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("skybench: no CUDA card; the benchmark runs only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"skybench: {cell.name} needs {cell.chips} cards, this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                       t0=T0)
    found = harness.banned_modules()
    if found:
        print(f"skybench: {found} loaded in the benchmark's process; "
              f"no result", file=sys.stderr)
        return 3
    harness.emit(line)
    return 0


if __name__ == "__main__":
    # one host thread for the program's CPU-side ops (numpy and torch
    # pools spinning on a shared host's cores widen the runs' spread)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    # the checkout's root (for ``skybench``) and ``src`` (for the
    # program), in place of this script's own directory
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
