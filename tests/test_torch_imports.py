"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
BANNED = ("jax", "jaxlib", "repro")


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
            node.func, "attr", getattr(node.func, "id", "")
        ) in ("import_module", "__import__"):
            out += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)]
    return out


def test_port_files_exist():
    assert len(FILES) > 20
    assert all(p.exists() for p in FILES)


@pytest.mark.parametrize("module", [
    "configs/base.py", "configs/archs.py", "configs/shapes.py",
    "sharding/specs.py", "models/params.py", "models/layers.py",
    "models/attention.py", "models/ssm.py", "models/transformer.py",
    "models/model.py", "models/moe.py", "serve/serve_step.py",
    "launch/serve.py", "launch/inputs.py",
    "kernels/nvcc.py", "kernels/flash_attention/ops.py",
    "kernels/flash_attention/ref.py", "kernels/ssd_scan/ops.py",
    "kernels/ssd_scan/ref.py", "kernels/quantize/ops.py",
    "kernels/quantize/ref.py", "transfer/compression.py", "transfer/chunk.py",
    "data/pipeline.py", "tree.py", "train/optimizer.py", "train/train_step.py",
    "train/trainer.py", "ckpt/checkpoint.py", "launch/train.py",
    "convert.py",
])
def test_model_path_modules_are_checked(module):
    """The model path's modules are among the files checked below."""
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("module", [
    "core/ron.py", "transfer/flowsim.py", "transfer/flowsim_ref.py",
    "transfer/sim.py", "transfer/simconfig.py", "transfer/events.py",
    "transfer/breaker.py", "transfer/chaos.py", "transfer/reports.py",
    "transfer/executor.py", "transfer/gateway.py", "ckpt/replicate.py",
    "obs/export.py", "obs/__main__.py", "launch/plan.py",
    "data/placement.py", "configs/smollm_135m.py", "configs/zamba2_7b.py",
    "configs/mixtral_8x22b.py", "configs/llama_32_vision_11b.py",
    "configs/mamba2_1_3b.py", "configs/mistral_large_123b.py",
    "configs/nemotron_4_340b.py", "configs/qwen2_7b.py",
    "configs/qwen3_moe_30b_a3b.py", "configs/seamless_m4t_medium.py",
    "calibrate/__init__.py", "calibrate/drift.py", "calibrate/belief.py",
    "calibrate/policies.py", "calibrate/calibrator.py",
    "calibrate/service.py", "transfer/fleet.py",
])
def test_transfer_plane_modules_are_checked(module):
    """The transfer plane's modules are among the files checked below."""
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("module", [
    "sharding/__init__.py", "launch/mesh.py", "launch/elastic.py",
    "launch/ranks.py", "transfer/collective.py", "analysis/__init__.py",
    "analysis/__main__.py", "analysis/engine.py", "analysis/rules.py",
    "launch/dryrun.py", "launch/hlo_stats.py",
])
def test_multi_device_modules_are_checked(module):
    """The multi-device layer's and skylint's modules are among the files
    checked below."""
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
