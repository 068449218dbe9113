"""Multi-pod dry run: build and count every (architecture x input shape x
mesh) cell on a fake process group — meta tensors only, no allocation —
and record memory/cost/collective statistics for the roofline analysis
(the port of ``repro/launch/dryrun.py``).

Per runnable cell this runs ONE step of the real program (the train step,
the prefill or the decode step) on the production mesh: a
``torch.distributed`` ``DeviceMesh`` of 256 (single pod) or 512 (two
pods) ranks over the ``fake`` backend, of which this process is rank 0.
The parameters, optimizer state, batch and caches are meta stand-ins
(``launch/inputs.py``) placed as DTensors by ``sharding.specs.device_put``,
and the step runs under ``hlo_stats.StepRecorder``, which counts every
op rank 0 issues at its local size: FLOPs, bytes, DTensor's collectives
and the pod ring's hops, and the peak of live bytes. Building the step
proves the sharding coherent, as the reference's lowering does.

The counts are eager, unfused and per device, and trip-faithful: eager
PyTorch runs every layer, so the reference's probe-delta extrapolation
over scanned layer groups has no counterpart, and the roofline is the
full step's own (``probe_groups`` is null).

Nothing happens at import: each cell starts its fake process group
inside ``run_cell`` and destroys it when counted.

Artifacts: artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json
(resumable: cells with an existing artifact are skipped unless --force).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
  ... --device cpu        (a CPU-typed mesh; the default is the card's)
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, applicable, get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import hlo_stats
from repro_torch.launch.inputs import (
    decode_logical,
    decode_state_sds,
    decode_tokens_sds,
    param_sds,
    train_batch_logical,
    train_batch_sds,
)
from repro_torch.launch.mesh import make_mesh_for, make_production_mesh
from repro_torch.models.model import abstract_params, count_params
from repro_torch.serve import make_serve_step
from repro_torch.sharding.specs import (
    ShardingRules,
    device_put,
    make_param_shardings,
    set_mesh,
    shardings_for,
)
from repro_torch.train import OptConfig, init_opt_state, make_train_step

DEFAULT_OUT = Path("artifacts/dryrun_torch")

# §Perf hillclimb variants: cumulative config overrides, measured one at a
# time against the paper-faithful baseline (EXPERIMENTS.md §Perf logs the
# hypothesis -> before/after for each).
VARIANTS: dict[str, dict] = {
    "baseline": {},
    "v1_embed": dict(embed_dmodel_shard=True),
    "v2_cast": dict(embed_dmodel_shard=True, cast_params_once=True),
    "v3_moe": dict(embed_dmodel_shard=True, cast_params_once=True,
                   moe_shard_dispatch=True),
    "v4_bf16s": dict(embed_dmodel_shard=True, cast_params_once=True,
                     moe_shard_dispatch=True, attn_scores_bf16=True),
    "v5_dots": dict(embed_dmodel_shard=True, cast_params_once=True,
                    moe_shard_dispatch=True, attn_scores_bf16=True,
                    remat_policy="dots"),
    "opt": dict(embed_dmodel_shard=True, cast_params_once=True,
                moe_shard_dispatch=True, attn_scores_bf16=True,
                remat_policy="dots"),
    # best per-cell combination found by the §Perf loop: bf16 scores REFUTED
    # (manual softmax defused on the measured backend), everything else kept
    "v6_best": dict(embed_dmodel_shard=True, cast_params_once=True,
                    moe_shard_dispatch=True, remat_policy="dots"),
    # multi-pod only: explicit planner-ordered int8 ring for the pod-axis
    # gradient reduction (the paper's egress-volume lever on the DCN)
    "podring": dict(embed_dmodel_shard=True, cast_params_once=True,
                    moe_shard_dispatch=True, remat_policy="dots"),
    # SSD chunk-size hypothesis (SSM archs): intra-chunk decay/score bytes
    # scale with S*Q (nc*Q^2 = S*Q), so smaller Q should cut the SSD memory
    # term ~Q-proportionally at the cost of more (tiny) recurrence steps.
    "v7_ssdq64": dict(embed_dmodel_shard=True, cast_params_once=True,
                      moe_shard_dispatch=True, remat_policy="dots",
                      _ssd_chunk=64),
    "v7_ssdq128": dict(embed_dmodel_shard=True, cast_params_once=True,
                       moe_shard_dispatch=True, remat_policy="dots",
                       _ssd_chunk=128),
    # MoE combine via scatter-from-experts + psum (vs buffer all-gather)
    "v8_moecomb": dict(embed_dmodel_shard=True, cast_params_once=True,
                       moe_shard_dispatch=True, remat_policy="dots",
                       moe_psum_combine=True),
}


def _apply_overrides(cfg: ModelConfig, overrides: dict) -> ModelConfig:
    ov = dict(overrides)
    ssd_chunk = ov.pop("_ssd_chunk", None)
    cfg = dataclasses.replace(cfg, **ov)
    if ssd_chunk and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=ssd_chunk)
        )
    return cfg


def rules_for(shape: ShapeSpec) -> ShardingRules:
    """Baseline sharding scheme per input shape (the §Perf starting point)."""
    if shape.name == "long_500k":
        # batch=1: context parallelism — shard the KV/SSM sequence dim over
        # the data axis instead of the (unshardable) batch dim.
        return ShardingRules(batch=None, fsdp="data", tp="model", seq="data")
    return ShardingRules(batch=("pod", "data"), fsdp="data", tp="model", seq=None)


@contextlib.contextmanager
def _fake_group(world: int):
    """A ``fake`` process group of ``world`` ranks, this process rank 0:
    collectives return at once and move nothing. Destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def _lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: ShardingRules,
                podring: bool = False):
    """Place this cell's meta stand-ins on ``mesh`` and run one step of it
    under a ``StepRecorder``; returns the closed recorder."""
    set_mesh(mesh)
    abstract = abstract_params(cfg)
    if shape.kind == "train":
        pshard = make_param_shardings(mesh, rules, abstract)
        params = device_put(param_sds(cfg), pshard)  # f32 master weights
        opt = init_opt_state(params)
        bsds = train_batch_sds(cfg, shape)
        batch = device_put(
            bsds, shardings_for(mesh, rules, train_batch_logical(cfg), bsds))
        if podring and "pod" in mesh.mesh_dim_names:
            from repro_torch.train.train_step import make_podring_train_step

            step = make_podring_train_step(cfg, rules, OptConfig(), mesh,
                                           compress_wire=True)
        else:
            step = make_train_step(cfg, rules, OptConfig())
        return _record(step, params, opt, batch)
    # serving cells run bf16 params
    cfg_serve = dataclasses.replace(cfg, param_dtype="bfloat16")
    abstract = abstract_params(cfg_serve)
    pshard = make_param_shardings(mesh, rules, abstract)
    params = device_put(param_sds(cfg_serve, dtype=torch.bfloat16), pshard)
    if shape.kind == "prefill":
        from repro_torch.serve import make_prefill_step

        bsds = train_batch_sds(cfg_serve, shape)
        bsds.pop("labels")
        blog = train_batch_logical(cfg_serve)
        blog.pop("labels")
        batch = device_put(bsds, shardings_for(mesh, rules, blog, bsds))
        step = make_prefill_step(cfg_serve, rules, t_max=shape.seq_len)
        return _record(step, params, batch)
    # decode
    ssds = decode_state_sds(cfg_serve, shape)
    state = device_put(
        ssds, shardings_for(mesh, rules, decode_logical(cfg_serve), ssds))
    tsds = decode_tokens_sds(cfg_serve, shape)
    tokens = device_put(tsds, shardings_for(mesh, rules, ("batch", None), tsds))
    step = make_serve_step(cfg_serve, rules)
    return _record(step, params, state, tokens)


def _record(step, *args) -> hlo_stats.StepRecorder:
    with hlo_stats.StepRecorder(args) as rec:
        out = step(*args)
    return rec.close(out)


def _stats_of(rec: hlo_stats.StepRecorder) -> dict:
    st = {}
    st.update(hlo_stats.cost_stats(rec))
    st.update(hlo_stats.memory_stats(rec))
    st["collectives"] = rec.collectives.as_dict()
    st["wire_bytes_per_device"] = rec.collectives.wire_bytes
    return st


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             probes: bool = True, rules: ShardingRules | None = None,
             variant: str = "baseline", device=None) -> dict:
    """One cell's artifact, in the reference's schema, counted on the mesh
    kind's production mesh over a fake process group of its size."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    art: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant,
        "kind": shape.kind,
        "params": count_params(cfg),
        "params_active": count_params(cfg, active_only=True),
    }
    runs, why = applicable(cfg, shape)
    if not runs:
        art["status"] = "skipped"
        art["skip_reason"] = why
        return art

    multi = mesh_kind == "multi"
    with _fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device=device)
        art["mesh_shape"] = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
        rules = rules or rules_for(shape)
        overrides = VARIANTS.get(variant, {})
        art["overrides"] = overrides
        cfg_cell = _apply_overrides(
            dataclasses.replace(cfg, inner_unroll=True), overrides
        )

        podring = variant == "podring"
        t0 = time.time()
        full = _stats_of(_lower_cell(cfg_cell, shape, mesh, rules,
                                     podring=podring))
        art["full"] = full
        art["lower_compile_s"] = round(time.time() - t0, 2)
        n_dev = mesh.size()

    if probes:
        # the full step is trip-faithful (module docstring): its counts
        # are the roofline's, with no probe-delta extrapolation
        groups, _ = cfg.scan_groups()
        flops = full["flops_per_device"]
        bytes_ = full["bytes_per_device"]
        wire = full["wire_bytes_per_device"]
        terms = hlo_stats.roofline_terms(flops, bytes_, wire)
        model_flops = 6.0 * art["params_active"] * shape.global_batch * shape.seq_len
        if shape.kind != "train":
            # forward-only; decode touches 1 token
            tokens = shape.global_batch * (
                1 if shape.kind == "decode" else shape.seq_len
            )
            model_flops = 2.0 * art["params_active"] * tokens
        art["roofline"] = {
            "flops_per_device": flops,
            "bytes_per_device": bytes_,
            "wire_bytes_per_device": wire,
            **terms,
            "dominant": hlo_stats.dominant_term(terms),
            "model_flops_total": model_flops,
            "hlo_flops_total": flops * n_dev,
            "useful_flops_ratio": model_flops / max(flops * n_dev, 1.0),
            "probe_groups": None,
            "groups": groups,
        }
    return art


def count_step(cfg: ModelConfig, shape: ShapeSpec, mesh_shape=(1, 1), *,
               podring: bool = False, device=None) -> dict:
    """One step of ``cfg`` at ``shape``, counted as ``run_cell`` counts a
    cell (its ``full`` entry, under ``rules_for(shape)``) but on a mesh of
    ``mesh_shape``: ("data", "model") sizes, or ("pod", "data", "model")
    with three entries, over a fake group of that many ranks; ``podring``
    as the variant of that name. On a (1, 1) mesh the counts are one
    card's for the whole step."""
    n_pods = mesh_shape[0] if len(mesh_shape) == 3 else 1
    with _fake_group(math.prod(mesh_shape)):
        mesh = make_mesh_for(n_pods, *mesh_shape[-2:], device=device)
        return _stats_of(_lower_cell(cfg, shape, mesh, rules_for(shape),
                                     podring=podring))


def cell_path(out: Path, arch: str, shape: str, mesh: str,
              variant: str = "baseline") -> Path:
    suffix = "" if variant == "baseline" else f"__{variant}"
    return out / f"{arch}__{shape}__{mesh}{suffix}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: the card; "
                         "'cpu' builds a CPU mesh)")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = cell_path(out, arch, shape, mesh_kind, args.variant)
                if path.exists() and not args.force:
                    print(f"skip (exists): {path.name}")
                    continue
                t0 = time.time()
                try:
                    # probes only add information on the single-pod roofline
                    probes = (not args.no_probes) and mesh_kind == "single"
                    art = run_cell(arch, shape, mesh_kind, probes=probes,
                                   variant=args.variant, device=args.device)
                    art["status"] = art.get("status", "ok")
                except Exception as ex:  # noqa: BLE001 - record and continue
                    art = {
                        "arch": arch, "shape": shape, "mesh": mesh_kind,
                        "status": "error", "error": str(ex)[:2000],
                        "traceback": traceback.format_exc()[-4000:],
                    }
                    failures += 1
                art["wall_s"] = wall = round(time.time() - t0, 2)
                path.write_text(json.dumps(art, indent=2))
                status = art["status"]
                print(f"{path.name}: {status} ({wall}s)")
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
