"""CLI entry point: ``python -m repro_torch.analysis check [paths] [--format=...]``.

Exit codes: 0 clean, 1 findings, 2 usage error. ``--format=text`` (default)
prints one line per finding plus a summary; ``--format=json`` emits the full
report — findings, active rules, and the pragma allowlist audit — for the CI
artifact. ``--output FILE`` additionally writes the JSON report to a file
regardless of the chosen display format.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import check


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="skylint: repo-invariant static analysis",
    )
    sub = parser.add_subparsers(dest="command")
    p_check = sub.add_parser("check", help="lint the given paths")
    p_check.add_argument(
        "paths", nargs="*", default=["src", "tests", "benchmarks", "examples"],
        help="files or directories, relative to --root (default: "
        "src tests benchmarks examples)",
    )
    p_check.add_argument(
        "--format", choices=("text", "json"), default="text",
        dest="fmt", help="report format on stdout",
    )
    p_check.add_argument(
        "--root", default=".",
        help="repo root the rule path-scopes are resolved against",
    )
    p_check.add_argument(
        "--output", default=None, metavar="FILE",
        help="also write the JSON report to FILE",
    )
    args = parser.parse_args(argv)
    if args.command != "check":
        parser.print_help()
        return 2

    root = Path(args.root).resolve()
    paths = [p for p in args.paths if (root / p).exists()]
    if not paths:
        print(f"skylint: no such paths under {root}: {args.paths}",
              file=sys.stderr)
        return 2

    report = check(root, paths)
    print(report.to_json() if args.fmt == "json" else report.to_text())
    if args.output:
        Path(args.output).write_text(report.to_json() + "\n",
                                     encoding="utf-8")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
