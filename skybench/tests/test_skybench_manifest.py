"""``BENCHMARK.json`` against the contract's shape, the files it names,
the traffic generator's determinism, and one run of the harness to its
last line."""

import io
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from skybench.tests.tiny import CELLS, tiny

SKYBENCH = Path(__file__).resolve().parents[1]
ROOT = SKYBENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MANIFEST["command"][:1] == ["python3"]
    assert all(isinstance(w, str) and 0 < len(w) <= 200
               for w in MANIFEST["command"])
    assert MANIFEST["paths"] == ["skybench"]
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for section, keys in KEYS.items():
        for entry in MANIFEST[section]:
            extra = {"workloads"} if section in ("end_to_end",
                                                 "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, entry


def test_names_and_units_use_the_allowed_characters():
    names = []
    for section in KEYS:
        names += [e["name"] for e in MANIFEST[section]]
    for w in MANIFEST["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in MANIFEST["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), names
    for section in ("end_to_end", "per_layer"):
        assert len({m["name"] for m in MANIFEST[section]}) == len(
            MANIFEST[section])
        for m in MANIFEST[section]:
            assert UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in MANIFEST["workloads"]]
                 + [c["why"] for c in MANIFEST["configs"]]
                 + [c["source"] for c in MANIFEST["configs"]]
                 + [m["layer"] for m in MANIFEST["per_layer"]]):
        assert 0 < len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_name_their_layer_and_what_they_move():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    # Every cell, and every cell a later manifest adds, reports setup_s.
    assert "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["per_layer"]:
        assert m["layer"].strip() and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", moved)) <= moved
    for cell in cells:
        reported = {m["name"] for m in MANIFEST["end_to_end"]
                    if cell in m.get("workloads", cells)}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in MANIFEST["per_layer"])


def test_every_file_the_manifest_names_exists():
    from skybench import cells

    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for c in configs.values():
        path = ROOT / c["file"]
        assert c["file"].startswith("skybench/") and path.is_file()
        assert json.loads(path.read_text())["name"] == c["name"]
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        mix = w["traffic"]
        assert (SKYBENCH / "traffic" / f"{mix}.json").is_file()
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert callable(cells.metric_reader(m["name"]).read)
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(configs)
    assert len({(w["config"], w["traffic"])
                for w in MANIFEST["workloads"]}) == len(MANIFEST["workloads"])
    for p in SKYBENCH.rglob("*"):
        if "__pycache__" not in p.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$",
                            str(p.relative_to(ROOT))), p


@pytest.mark.parametrize("name", CELLS)
def test_the_traffic_generator_is_deterministic_in_the_seed(name):
    from skybench import cells

    cell = cells.load_cell(name)
    pool = cell.traffic["sim_seed_pool"]

    def draw(seed):
        s = cells.sim_seeds(seed, pool)
        return cells.job_specs(cell.config, cell.traffic), [
            next(s) for _ in range(2 * len(pool))]

    assert draw(2**31 + 9) == draw(2**31 + 9)
    assert draw(2**31 + 9)[1] != draw(2**31 + 10)[1]
    assert draw(2**31 + 9)[0] == draw(2**31 + 10)[0]  # the same work
    # every run takes the whole pool, in its own order
    first = draw(-3)[1][:len(pool)]
    assert sorted(first) == sorted(pool)
    assert draw(-3)[1][len(pool):] == first


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_reaches_the_contracts_last_line(name, trace):
    from skybench import harness

    cell = tiny(name)
    out, err = io.StringIO(), io.StringIO()
    harness.emit(harness.run(cell, 2**31 + 99, 0.3, trace, device="cpu",
                             err=err), out=out)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1 + trace
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= set(want)
    if not trace:
        assert set(line["metrics"]) == {"sim_chunks_per_s", "setup_s"}
    else:
        assert "breakdown" in line and "busy_s" in line["device"]
        assert "useful_iteration_share" in line["metrics"]
    for m in line["metrics"].values():
        assert m["unit"] == cell.units[
            next(k for k, v in line["metrics"].items() if v is m)]
    tail = err.getvalue().strip().splitlines()[-2:]
    assert [t.split()[1] for t in tail] == ["fields_differing",
                                            "max_rel_gap"]


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "skybench/run.py", "--workload", "direct-2vm.bulk",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_correct_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "skybench/run.py", "--workload", name,
         "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"sim_chunks_per_s", "setup_s"}
