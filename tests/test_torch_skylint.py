"""skylint over the whole tree finds nothing in the port's own files.

``test_skylint.py::test_live_repo_is_clean`` gates the whole tree, and
it already fails on warnings in reference, benchmark and example files,
so a new finding in a port file would not change its result. This test
runs the same check over the same tree (so that cross-file rules such as
SKY010 see every caller), plus ``chip_smoke.py``, and fails on any
finding whose path is a port file: under ``src/repro_torch/``, a
``tests/test_torch_*.py`` file, or ``chip_smoke.py``.
"""

from __future__ import annotations

from pathlib import Path

from repro.analysis import check

REPO_ROOT = Path(__file__).resolve().parents[1]
TREE = ["src", "tests", "benchmarks", "examples"]


def is_port_file(path: str) -> bool:
    name = path.rsplit("/", 1)[-1]
    return (path.startswith("src/repro_torch/") or path == "chip_smoke.py"
            or (path.startswith("tests/") and name.startswith("test_torch_")
                and name.endswith(".py")))


def test_port_files_are_what_the_rule_means():
    assert is_port_file("src/repro_torch/transfer/flowsim_torch.py")
    assert is_port_file("tests/test_torch_skylint.py")
    assert is_port_file("chip_smoke.py")
    assert not is_port_file("src/repro/transfer/sim.py")
    assert not is_port_file("tests/test_skylint.py")
    assert not is_port_file("tests/test_torch_cases.txt")


def test_skylint_finds_nothing_in_port_files():
    rep = check(REPO_ROOT, [*TREE, "chip_smoke.py"])
    assert rep.files_scanned > 0
    port = [f for f in rep.findings if is_port_file(f.path)]
    assert not port, "\n" + "\n".join(f.format() for f in port)


def test_the_check_sees_the_port_and_chip_smoke():
    """The walk reaches every kind of port file, so the test above is not
    vacuous."""
    from repro.analysis.engine import load_tree

    files = load_tree(REPO_ROOT, [*TREE, "chip_smoke.py"]).files
    assert "chip_smoke.py" in files
    assert "src/repro_torch/transfer/flowsim_torch.py" in files
    assert "tests/test_torch_skylint.py" in files
