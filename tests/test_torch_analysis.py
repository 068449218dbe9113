"""The port's copy of skylint against the reference's.

Every case of ``test_skylint.py`` runs as written with its ``check``
replaced by one that runs both packages' ``check`` on the same tree,
requires their JSON reports to be equal (findings, rules, pragma audit,
files scanned), and hands the port's report to the case's own asserts;
``active_rule_ids`` is the port's. The CLI case runs ``python -m
repro_torch.analysis`` beside ``python -m repro.analysis`` (equal output
and exit codes: 0 clean, 1 findings, 2 usage), and the whole tree's
report through the port's CLI, text and JSON, is the reference's
``check`` report with its exit code.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path

import pytest

import test_skylint as ref_cases
from repro import analysis as ref
from repro_torch import analysis as port

REPO_ROOT = Path(__file__).resolve().parents[1]
TREE = ["src", "tests", "benchmarks", "examples"]
# run below on their own: the CLI through both modules, the whole tree
# through both packages (the reference's own gate fails on it, as the
# whole tree holds findings)
OWN = {"test_cli_exit_codes_and_json_output", "test_live_repo_is_clean"}
CASES = sorted(n for n, f in vars(ref_cases).items()
               if n.startswith("test_") and callable(f) and n not in OWN)


def _both(root, paths):
    want = ref.check(root, paths)
    got = port.check(root, paths)
    assert got.to_json() == want.to_json()
    assert got.to_text() == want.to_text()
    return got


@pytest.mark.parametrize("name", CASES)
def test_skylint_case_through_both_packages(name, tmp_path, monkeypatch):
    monkeypatch.setattr(ref_cases, "check", _both)
    monkeypatch.setattr(ref_cases, "active_rule_ids", port.active_rule_ids)
    case = getattr(ref_cases, name)
    args = [tmp_path] if inspect.signature(case).parameters else []
    case(*args)


def test_rule_tables_are_the_references():
    assert port.active_rule_ids() == ref.active_rule_ids()
    for a, b in zip(port.active_rules(), ref.active_rules()):
        assert (a.id, a.severity, a.description, a.hint) == (
            b.id, b.severity, b.description, b.hint)


def _cli(module: str, root: Path, *args: str):
    return subprocess.run(
        [sys.executable, "-m", module, "check", *args, "--root", str(root)],
        capture_output=True, text=True, cwd=REPO_ROOT,
        env={"PYTHONPATH": str(REPO_ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )


def test_cli_exit_codes_and_output_equal_the_references(tmp_path):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "clean.py").write_text('X = "ok"\n', encoding="utf-8")
    runs = []
    for step in ("clean", "bad", "missing"):
        if step == "bad":
            (tmp_path / "src" / "bad.py").write_text(
                "top.tput[0, 1] = 5.0\n", encoding="utf-8")
        args = ("nowhere",) if step == "missing" else ("src", "--format",
                                                       "json")
        got = _cli("repro_torch.analysis", tmp_path, *args)
        want = _cli("repro.analysis", tmp_path, *args)
        assert (got.returncode, got.stdout) == (want.returncode, want.stdout)
        runs.append(got)
    assert [r.returncode for r in runs] == [0, 1, 2]
    assert json.loads(runs[0].stdout)["ok"] is True
    assert [f["rule"] for f in json.loads(runs[1].stdout)["findings"]] == [
        "SKY003"]


@pytest.fixture(scope="module")
def whole_tree(tmp_path_factory):
    """The whole tree's report: the port's CLI in two subprocesses (text;
    JSON with --output), the reference's ``check`` in this process
    meanwhile."""
    out = tmp_path_factory.mktemp("skylint") / "out.json"
    args = ["check", *TREE, "--root", str(REPO_ROOT)]
    procs = {fmt: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", *args, "--format",
         fmt, *(["--output", str(out)] if fmt == "json" else [])],
        stdout=subprocess.PIPE, text=True, cwd=REPO_ROOT,
        env={"PYTHONPATH": str(REPO_ROOT / "src"), "PATH": "/usr/bin:/bin"})
        for fmt in ("text", "json")}
    want = ref.check(REPO_ROOT, TREE)
    got = {}
    for fmt, proc in procs.items():
        stdout, _ = proc.communicate(timeout=300)
        got[fmt] = (proc.returncode, stdout)
    return want, got, out.read_text(encoding="utf-8")


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_whole_tree_report_equals_the_references(fmt, whole_tree):
    want, got, written = whole_tree
    text = want.to_json() if fmt == "json" else want.to_text()
    assert got[fmt] == (0 if want.ok else 1, text + "\n")
    if fmt == "json":
        assert written == want.to_json() + "\n"
        assert json.loads(written)["files_scanned"] > 100
