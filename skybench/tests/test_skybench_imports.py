"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their top-level part whole: the program ``repro_torch`` begins with the
JAX package's name ``repro``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

SKYBENCH = Path(__file__).resolve().parents[1]
ROOT = SKYBENCH.parent
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    """Top-level names of a file's absolute imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _harness_files():
    return sorted(p for p in SKYBENCH.rglob("*.py")
                  if "tests" not in p.relative_to(SKYBENCH).parts)


@pytest.mark.parametrize("path", _harness_files(),
                         ids=lambda p: str(p.relative_to(SKYBENCH)))
def test_no_file_of_the_harness_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & BANNED


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((SKYBENCH / "reference").rglob("*.py")):
        names = _imports(path)
        assert not names & (BANNED | {"repro_torch", "torch", "skybench"}), (
            path, names)
        assert names <= {"__future__", "collections", "dataclasses",
                         "functools", "hashlib", "numpy", "time", "typing",
                         "warnings"}, (path, names)


def test_a_run_loads_no_jax_module():
    """A whole run of each tiny cell, traced, in a fresh process: the
    modules it loaded, compared by top-level name."""
    src = str(ROOT / "src")
    code = f"""
import json, sys
sys.path[0:0] = [{str(ROOT)!r}, {src!r}]
import torch
torch.set_num_threads(1)
from skybench import harness
from skybench.tests.tiny import CELLS, tiny
for name in CELLS:
    harness.run(tiny(name), 7, 0.2, True, device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "skybench" in loaded
    assert not loaded & BANNED
