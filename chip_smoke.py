"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py [--out FILE.json]

Skyplane's main path is plan, then move. This script builds the port's
CUDA kernels (one nvcc per source under ``src/repro_torch/kernels/*/csrc``,
all started together), holds each against its plain PyTorch version, then
plans the Fig. 6 route on the card (batched torch IPM) and moves the
plan's chunks through the device-resident sim, first at 10,240 chunks of
64 MB with scripted faults (held field for field against the same run on
the CPU), then at 100,000 chunks; on the card the sim runs each block of
iterations as a replayed CUDA graph, and the sim phases report the graphs
captured, their capture seconds and their replays; ``[sim_1e5]``
brackets every block with CUDA events for the card's idle share. The
transfer service follows, with the launch counts set to 0 again: the
multi-job benchmark's service block at 10,240 chunks a job
(``[service]``) and 8 of the chaos benchmark's 16 services
(``[service_chaos]``), each run by ``TransferService`` on the card (torch
IPM, the card's sim) and on the CPU (torch IPM, the ``soa`` engine) and
held equal run for run. The calibrated path follows, the counts set to 0
again, each run the same way: the calibration benchmark's calibrated and
stale services (``[calibrated]``), the probe-policy benchmark's race and
epoch rolls (``[probe_race]``), the fleet benchmark's fleet of 24 jobs in
1 MB chunks and its three isolated services (``[fleet_service]``), each
checked against what its benchmark asserts, and the fleet's cohort
admission (``[fleet_cohort]``); then the sim's kernels against their
plain versions at every service phase's shapes. The model path follows:
the flash
attention kernels (bf16 on the tensor cores, f32 on the vector units) and
the SSD scan kernel against their plain versions at Zamba2-7B's shapes
and others, both flash kernels timed beside
``scaled_dot_product_attention``, then ``zamba2-7b`` at full width and
depth (6.75e9 f32 parameters from a seed): served through
``repro_torch.launch.serve`` (a 4 x 4096 prefill, then greedy decode),
its ``forward`` with the kernels
against the plain path, and a reduced copy on the card against the CPU.
The rest of the model zoo follows, each serving phase with the launch
counts set to 0 just before it and profiled after it: ``qwen3-moe-30b-a3b``
at full width cut to 12 of its 48 layers (8.10e9 f32 parameters) through
``launch.serve.generate`` with its routing recorded (the share of
assignments that capacity dropped, the expert load), then
``llama-3.2-vision-11b`` and ``seamless-m4t-medium`` at full size through
``launch.serve.main`` (vision tokens and audio frames from its seed);
then the four zoo families reduced, and Qwen3-MoE at full width and two
layers, each on the card against the CPU, MoE routing compared first.
The training path comes last: the int8 quantize and dequantize kernels
bit for bit against their plain versions at every gradient leaf of
``smollm-135m`` and at ragged, zero, tie, bf16 and NaN inputs; then
``smollm-135m`` at full width and depth (1.345e8 f32 parameters from a
seed) trained by the port's ``Trainer`` as ``launch/train.py`` builds
it, 30 steps of 8 x 2048 tokens with every gradient leaf through the
kernels and a restart from the step-10 checkpoint after a failure
injected at step 17; error feedback over its real gradients; and a
smaller trainer on the card against the CPU. Each phase prints one
line; the line before the last lists every kernel with its launches on
the main paths, its error against its plain version, its time and its
bound; the last line is the device summary. Any failed
check raises, and the script then exits non-zero without the summary. It
exits non-zero at once where there is no CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC, DST = "aws:us-east-1", "aws:ap-southeast-2"  # Fig. 6 panel 1 route
FIG6_VOLUME_GB = 640.0  # 10,240 chunks of 64 MB
BIG_SRC, BIG_DST = "aws:us-west-2", "aws:eu-central-1"
BIG_CHUNKS = 100_000
CHUNK_MB = 64.0
# [sim_fleet]: direct jobs of 8 VMs x 64 connections (512 lanes each, the
# topology's per-VM and per-region limits), 8 chunks of 16 MB each, over
# three routes; 48 of them hold 24,576 lanes, twice what one water-filling
# block's shared memory takes, so every solve takes the kernel's
# device-memory variant
FLEET_JOBS, FLEET_CHUNKS, FLEET_CHUNK_MB = 48, 8, 16.0
FLEET_ROUTES = (("aws:us-east-1", "aws:ap-southeast-2"),
                ("aws:us-west-2", "aws:eu-central-1"),
                ("gcp:us-central1", "gcp:europe-west1"))
# [service]: benchmarks/multijob_bench.py's service block (:24-37, :63-66):
# jobs a and b on the Fig. 6 route (b at 1 s), c from SERVICE_SRC2, a
# 4 Gbps goal each, at the [sim] phase's 10,240 chunks of 64 MB a job
SERVICE_SRC2 = "gcp:us-central1"
SERVICE_VOLUME_GB, SERVICE_GOAL_GBPS = 640.0, 4.0
# [service_chaos]: benchmarks/chaos_bench.py:20-64 at its full (non-FAST)
# size but for its seeds: seeds 0-3 of its 0-7 (the calibrated path below
# needs the time), each with and without the breaker, two 4 GB jobs in
# 16 MB chunks
CHAOS_SRC, CHAOS_DST, CHAOS_SRC2 = ("aws:us-west-2", "aws:eu-central-1",
                                    "gcp:us-central1")
CHAOS_SEEDS = (0, 1, 2, 3)
CHAOS_VOLUME_GB = 4.0
# the calibrated path, each phase one of the repo's benchmarks at its full
# (non-FAST) size. [calibrated]: benchmarks/calibration_bench.py:29-70, one
# 8 GB job at a 4 Gbps goal across a step-change incident (severity 0.08
# at 6 s) on the stale plan's widest edge, calibrated and stale
CAL_SRC, CAL_DST = "aws:us-west-2", "aws:eu-central-1"
CAL_GOAL_GBPS, CAL_VOLUME_GB = 4.0, 8.0
CAL_SEGMENTS = 150
# [probe_race]: benchmarks/probe_policy_bench.py:142-188, the benchmark's
# FAST arms (greedy and EVOI; the script's time limit) each racing three
# 4 GB jobs (one per provider, its full volume) across staggered incidents
# on a 3-probe budget; then :191-245, 8 GB on a belief that undersells the
# source's egress 20x, with epoch rolls and without
PROBE_CONTEXTS = (("aws:us-west-2", "aws:eu-central-1"),
                  ("gcp:us-central1", "gcp:europe-west1"),
                  ("azure:eastus", "azure:westeurope"))
PROBE_POLICIES = ("greedy", "evoi")
PROBE_VOLUME_GB, ROLL_VOLUME_GB = 4.0, 8.0
# [fleet_service]: benchmarks/fleet_bench.py:32-135, three tenants of
# eight jobs (2/4/3/6 GB cycled, 1 MB chunks, staggered 12 s), a 4-VM
# quota each, an incident at 6 s on the shared route's busiest edge: the
# fleet arm, then each tenant's isolated calibrated service (on the card;
# the CPU twin runs the fleet arm alone, for the script's time limit)
TENANT_SRC2 = "azure:canadacentral"
TENANT_JOBS, TENANT_SIZES_GB = 8, (2.0, 4.0, 3.0, 6.0)
TENANT_STAGGER_S, TENANT_CHUNK_MB = 12.0, 1.0
# H100 SXM (NVIDIA data sheet): HBM3 bytes/s, and the vector (non-tensor)
# peaks the kernels' float operations run at
HBM_BYTES_S = 3.35e12
PEAK_OPS = {"f64": 34e12, "f32": 67e12}
BF16_TENSOR_OPS = 989e12  # dense bf16 on tensor cores
WF_SOURCE = "src/repro_torch/kernels/waterfill/csrc/waterfill.cu"
WF_TPU = "src/repro/kernels/waterfill/waterfill.py:41"
SEGSUM_REPLACES = "src/repro/transfer/flowsim_jax.py:325"
# bf16 flash attention runs on the tensor-core kernel; f32 keeps the
# vector-unit kernel
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_wgmma.cu"
FLASH_VECTOR_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu")
FLASH_TPU = "src/repro/kernels/flash_attention/flash_attention.py:32"
# bf16 SSD at the tensor-core kernel's shapes runs on it; f32 keeps the
# vector-unit kernel
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_wgmma.cu"
SSD_VECTOR_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_TPU = "src/repro/kernels/ssd_scan/ssd_scan.py:30"
# kernel-check shapes: Zamba2-7B's own (the model path), a GQA one
# (qwen2-7b, 28:4 heads), a sliding-window one (mixtral's 4096 at 8192)
# and a ragged S for each kernel
FLASH_CASES = {
    "zamba2": dict(b=4, s=4096, h=32, kv=32, d=112, window=None),
    "qwen2_gqa": dict(b=1, s=4096, h=28, kv=4, d=128, window=None),
    "mixtral_window": dict(b=1, s=8192, h=48, kv=8, d=128, window=4096),
    "ragged": dict(b=2, s=1000, h=32, kv=32, d=112, window=None),
}
SSD_CASES = {
    "zamba2": dict(b=4, s=4096, h=112, p=64, n=64, q=256),
    "ragged": dict(b=2, s=1000, h=112, p=64, n=64, q=256),
    "p32_n128": dict(b=1, s=2048, h=16, p=32, n=128, q=256),
}
# the shapes the zoo's serving phases give the flash kernel: qwen3-moe-30b-a3b
# and llama-3.2-vision-11b (GQA 32:4 and 32:8 at D 128) at 4 x 4096,
# seamless-m4t-medium's decoder (16 heads of 64) at 4 x 1024; held against
# the plain version in [flash], not timed
ZOO_FLASH_CASES = {
    "qwen3_moe": dict(b=4, s=4096, h=32, kv=4, d=128, window=None),
    "llama_vision": dict(b=4, s=4096, h=32, kv=8, d=128, window=None),
    "seamless": dict(b=4, s=1024, h=16, kv=16, d=64, window=None),
}
# the tolerances of tests/test_kernels.py:45,84
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-1}
SERVE_ARGS = ["--arch", "zamba2-7b", "--full", "--batch", "4",
              "--prompt-len", "4096", "--decode", "32"]
MODEL_B, MODEL_S = 4, 4096
# [forward]: the kernels' path against the plain path (einsum attention,
# ssd_chunked), both in f32, same parameters and tokens, relative to the
# largest plain value. They differ only in the order the kernels sum in:
# the f32 SSD kernel is within ~1.6e-5 of its plain version, relative, at
# Zamba2's shape ([ssd]), and 108 random-weight sublayers amplify that
# ~100x (1.9e-3 on the hidden state, 7.1e-4 on the logits, on an H100).
# A kernel fault (a wrong mask, tile or chunk) moves them by O(1). The
# bf16 forward with the kernels (the model's own type, the one whose
# launches are counted) is compared and printed only: its rounding (2^-8
# per op) drifts O(1) logits from f32 at this depth.
FORWARD_F32_RTOL = 1e-2
# [model_cpu]: f32 card (kernels, cuBLAS f32) against CPU (plain versions)
MODEL_CPU_TOL = 1e-3
# [serve_moe]: qwen3-moe-30b-a3b at full width cut to 12 of its 48 layers
# (the 48 are 30.5e9 f32 parameters, 122 GB); B 4 x S 4096, 31 greedy steps
MOE_ARCH, MOE_LAYERS, MOE_PARAMS = "qwen3-moe-30b-a3b", 12, 8_099_776_512
ZOO_B, ZOO_S, ZOO_DECODE = 4, 4096, 32
VLM_ARGS = ["--arch", "llama-3.2-vision-11b", "--full", "--batch", "4",
            "--prompt-len", "4096", "--decode", "32"]
ENCDEC_ARGS = ["--arch", "seamless-m4t-medium", "--full", "--batch", "4",
               "--prompt-len", "1024", "--decode", "32"]
# [moe_cpu]: qwen3-moe at full width, 2 layers, f32, card against CPU
MOE_CPU_LAYERS, MOE_CPU_B, MOE_CPU_S = 2, 2, 256
# a token whose routing differs between card and CPU must sit at a
# near-tie: its k-th and (k+1)-th router probabilities within this,
# relative; such tokens leave the output checks, and may not pass 1%
NEAR_TIE, MAX_TIE_SHARE = 1e-5, 0.01
ZOO_ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x22b", "llama-3.2-vision-11b",
             "seamless-m4t-medium")
QUANT_SOURCE = "src/repro_torch/kernels/quantize/csrc/quantize.cu"
QUANT_TPU = "src/repro/kernels/quantize/quantize.py:19"
DEQUANT_TPU = "src/repro/kernels/quantize/quantize.py:28"
QUANT_BLOCK = 256
# the quantize kernels' times in the kernels line are for one training
# step's gradient: one launch per leaf
QUANT_WORK = "one smollm-135m gradient: one launch per leaf (11 leaves)"
# [train]: launch/train.py's smollm-135m at scale 1.0, batch 8 x 2048
TRAIN_ARCH, TRAIN_B, TRAIN_S = "smollm-135m", 8, 2048
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 30, 10, 17
# [train_cpu]: scale 0.25 in f32, card against CPU. Losses and the first
# step's f32 gradients differ only in summation order. The parameters go
# through int8 codes and AdamW, whose step m/(sqrt(v) + eps) is at most
# ~1.001 lr per entry over 3 steps (a weighted mean over a weighted root
# mean square): order noise that flips a code or the sign of a near-zero
# gradient moves an entry by up to that, whatever the gradient's size, so
# the two runs' parameters may be up to 2 x 1.001 x sum(lr) apart per
# entry, and no further
TRAIN_CPU_STEPS, TRAIN_CPU_B, TRAIN_CPU_S = 3, 4, 512
TRAIN_CPU_TOL = {"loss": 1e-4, "grads": 1e-3, "adam_steps": 2.01}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean time per call of ``fn`` over ``reps`` back-to-back calls, from
    CUDA events: device time plus any gap the host leaves between calls."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def profiled(fn):
    """Run ``fn`` under torch.profiler; returns (its result, the device
    events as (name, start_us, end_us))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    return out, dev


SPIN_CYCLES = 50_000_000  # ~25 ms of spinning at H100 clocks


def kernel_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` (which must not synchronise), with
    the host's launch gaps hidden: a spin kernel holds the card while the
    host enqueues every call, so the CUDA events bracket only the calls'
    device work. Raises if the spin ended before the host finished."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    b.synchronize()
    s0 = torch.cuda.Event(enable_timing=True)
    s1 = torch.cuda.Event(enable_timing=True)
    s0.record()
    torch.cuda._sleep(SPIN_CYCLES)
    s1.record()
    s1.synchronize()
    check(host_ms < s0.elapsed_time(s1), "the spin ended before the host "
          "had enqueued every call: the timing would include host gaps")
    return a.elapsed_time(b) / reps


# ------------------------------------------------------------- kernel inputs
def wf_inputs(su, dev, dtype, *, seed=None, edges=True):
    """Water-filling operands at a materialized scenario's shapes: every
    conn live (``seed`` None) or a seeded live subset with junk caps and
    indices in the dead lanes."""
    nc = su.conn_job.shape[0]
    ncp = max(8, -(-nc // 8) * 8)
    nv, ne = su.vm_eg_cap.shape[0], len(su.edges_used)
    caps = np.zeros(ncp)
    caps[:nc] = su.conn_rate
    src = np.zeros(ncp, dtype=np.int64)
    dst = np.zeros(ncp, dtype=np.int64)
    eid = np.zeros(ncp, dtype=np.int64)
    src[:nc], dst[:nc], eid[:nc] = su.conn_src, su.conn_dst, su.conn_edge
    active = np.arange(ncp) < nc
    if seed is not None:
        rng = np.random.default_rng(seed)
        active = (rng.uniform(size=ncp) < 0.7) & (np.arange(ncp) < nc)
        dead = ~active
        caps[dead] = 123.0
        src[dead] = rng.integers(0, nv, dead.sum())
        dst[dead] = rng.integers(0, nv, dead.sum())
        eid[dead] = rng.integers(0, ne, dead.sum())
    ed = np.array([su.top.tput[a, b] * 2.0 for a, b in su.edges_used])

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def i(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    return dict(
        caps=f(caps), src=i(src), dst=i(dst), eg_cap=f(su.vm_eg_cap),
        in_cap=f(su.vm_in_cap), eid=i(eid) if edges else None,
        ed_cap=f(ed) if edges else None,
        active=torch.as_tensor(active, device=dev),
    )


def to_cpu(args: dict) -> dict:
    return {k: None if v is None else v.cpu() for k, v in args.items()}


def wf_bound(args: dict, rounds: int, precision: str) -> tuple[float, str]:
    """Least time for one solve: each operand read once (the conn-to-VM
    and conn-to-edge maps once, as src/dst/eid), the rates written once;
    per live round ~12 float operations per lane and 2 per VM/edge
    budget."""
    nc, nv = args["caps"].shape[0], args["eg_cap"].shape[0]
    ne = 0 if args["ed_cap"] is None else args["ed_cap"].shape[0]
    n_maps = 2 if args["eid"] is None else 3
    e = 8 if precision == "f64" else 4
    nbytes = (
        nc * e + n_maps * nc * 4 + nc + 2 * nv * e + ne * e  # operands
        + nc * e  # rates out
    )
    ops = rounds * (12 * nc + 2 * (2 * nv + ne))
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_OPS[precision]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def live_rounds(args: dict, precision: str) -> tuple[int, int]:
    """(rounds, chain) of one solve: the rounds in which a lane is still
    unfixed (the bound's operation count), and per live round the most
    newly fixed nonzero rates in one segment, summed over the rounds (the
    longest chain of dependent adds the ordered budget sums force). The
    water-filling rounds redone in numpy at the kernel's precision,
    capped at the kernel's round bound."""
    dt, none, eps = ((np.float64, np.inf, 1e-12) if precision == "f64"
                     else (np.float32, np.float32(1e30), np.float32(1e-6)))
    a = {k: v.cpu().numpy() for k, v in args.items() if v is not None}
    caps, un = a["caps"].astype(dt), a["active"].astype(bool)
    maps = [(a["src"], a["eg_cap"]), (a["dst"], a["in_cap"])]
    if "ed_cap" in a:
        maps.append((a["eid"], a["ed_cap"]))
    bud = [b.astype(dt) for _, b in maps]
    ne = a["ed_cap"].shape[0] if "ed_cap" in a else 0
    bound = 2 * a["eg_cap"].shape[0] + ne + 4
    k = chain = 0
    while k < bound and un.any():
        share = np.full(caps.shape, none, dt)
        for (idx, _), b in zip(maps, bud):
            cnt = np.bincount(idx[un], minlength=b.shape[0]).astype(dt)
            seg = np.where(cnt > 0, b / np.maximum(cnt, 1), none).astype(dt)
            share = np.minimum(share, seg[idx])
        hit = un & (caps <= share + eps)
        cap_bound = hit.any()
        new = hit if cap_bound else un & (share <= share[un].min() + eps)
        rate = caps if cap_bound else share
        chain += max(int(np.bincount(idx[new & (rate != 0)]).max(initial=0))
                     for idx, _ in maps)
        for j, (idx, _) in enumerate(maps):
            used = np.bincount(idx[new], weights=rate[new],
                               minlength=bud[j].shape[0])
            bud[j] = np.maximum(bud[j] - used.astype(dt), 0).astype(dt)
        un &= ~new
        k += 1
    return k, chain


# ------------------------------------------------------------------- phases
def phase_build():
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.quantize import ops as quant_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.waterfill import build

    libs = [flash_ops.WGMMA_LIBRARY, ssd_ops.WGMMA_LIBRARY, build.LIBRARY,
            flash_ops.LIBRARY, ssd_ops.LIBRARY, quant_ops.LIBRARY]
    t0 = time.perf_counter()
    nvcc.build_all(libs)
    seconds = time.perf_counter() - t0
    card = card_line()
    print(card, flush=True)
    regs = {lib.source.name: sorted({
        ln.strip() for ln in lib.ptxas.splitlines()
        if "registers" in ln or "spill" in ln or "arning" in ln})
        for lib in libs}
    hgmma = sass_count(flash_ops.WGMMA_LIBRARY.path(), "HGMMA")
    check(hgmma and all(n > 0 for n in hgmma.values()),
          f"the tensor-core flash kernels hold no HGMMA: {hgmma}")
    ssd_hgmma = sass_count(ssd_ops.WGMMA_LIBRARY.path(), "HGMMA")
    check(ssd_hgmma and all(n > 0 for n in ssd_hgmma.values()),
          f"the tensor-core SSD kernels hold no HGMMA: {ssd_hgmma}")
    say("build", seconds=round(seconds, 3), card=card,
        nvcc_s={lib.source.name: round(lib.build_s, 3) for lib in libs},
        ptxas=regs, flash_wgmma_hgmma_by_head_dim=hgmma,
        ssd_wgmma_hgmma_by_state_atoms=ssd_hgmma)
    return card


def sass_count(lib: Path, opcode: str) -> dict:
    """Per kernel of a built library, the SASS instructions whose opcode
    starts with ``opcode``, from ``cuobjdump -sass``; keyed by the
    kernel's template argument (the head dim) where it has one."""
    from repro_torch.kernels.nvcc import nvcc

    tool = Path(nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts: dict = {}
    name = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            m = re.search(r"ILi(\d+)E", name)
            name = m.group(1) if m else name
            counts[name] = 0
        elif name is not None and re.search(rf"\b{opcode}", ln):
            counts[name] += 1
    return counts


def hold_sim_kernels(label, su, dev, errs) -> int:
    """The sim's kernels against their plain versions at a materialized
    scenario's shapes: water-filling (f64 bitwise, f32 within 1e-5) over
    seeded live subsets with and without edges, and the ordered segment
    sum (bitwise) at its per-(job, edge) map. A solve past one block's
    shared memory takes the device-memory variant, as the sim's would.
    Returns the water-filling cases run."""
    from repro_torch.kernels.waterfill import ops, ref

    n = 0
    for seed in range(4):
        for edges in (False, True):
            for precision, dtype in (("f64", torch.float64),
                                     ("f32", torch.float32)):
                args = wf_inputs(su, dev, dtype, seed=seed, edges=edges)
                ne = 0 if args["ed_cap"] is None else args["ed_cap"].shape[0]
                lanes = (wf_lanes(args, precision) if ops.lanes_in_device_memory(
                    args["caps"].shape[0], args["eg_cap"].shape[0], ne,
                    precision) else None)
                got = ops.waterfill_rates(**args, precision=precision,
                                          lanes=lanes)
                want = ops.waterfill_rates(**to_cpu(args),
                                           precision=precision)
                got = got.cpu()
                err = float((got - want).abs().max())
                errs[f"waterfill_{precision}"] = max(
                    errs.get(f"waterfill_{precision}", 0.0), err
                )
                if precision == "f64":
                    check(torch.equal(got, want),
                          f"f64 kernel != plain ({label}, seed {seed})")
                else:
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=1e-5)
                n += 1
    je = torch.as_tensor(su.conn_job * len(su.edges_used) + su.conn_edge,
                         device=dev)
    nseg = len(su.arrivals) * len(su.edges_used)
    w = torch.as_tensor(np.random.default_rng(9).uniform(
        0, 3, je.shape[0]), device=dev)
    got = ops.segment_sum_ordered(w, je, nseg).cpu()
    want = ref.segment_sum_ordered(w.cpu(), je.cpu(), nseg)
    check(torch.equal(got, want), f"segment sum != plain ({label})")
    errs["segsum_ordered_f64"] = max(errs.get("segsum_ordered_f64", 0.0),
                                     float((got - want).abs().max()))
    return n


def phase_waterfill(shapes, dev, errs):
    from repro_torch.kernels.waterfill import ops, ref

    n = sum(hold_sim_kernels(label, su, dev, errs)
            for label, su in shapes.items())
    times = {}
    for label, su in shapes.items():  # every lane live: the longest solve
        args = wf_inputs(su, dev, torch.float64)
        nv, ne = args["eg_cap"].shape[0], args["ed_cap"].shape[0]
        segs = ops.build_segments(args["src"], args["dst"], args["eid"], nv,
                                  ne)
        kw = dict(args, n_vms=nv, n_edges=ne)
        times[label] = dict(
            kernel_ms=kernel_ms(
                lambda: ops.waterfill_rates(**args, segments=segs), 20
            ),
            plain_ms=cuda_ms(lambda: ref.masked_maxmin_rates(**kw), 3),
        )
    say("waterfill", cases=n, f64_bitwise=True,
        max_abs_err={k: v for k, v in errs.items()}, f64_times=times)


def wf_lanes(args: dict, precision: str) -> torch.Tensor:
    """The device-memory variant's scratch for a solve of ``args``."""
    from repro_torch.kernels.waterfill import ops

    n = ops.scratch_bytes(args["caps"].shape[0], 8 if precision == "f64"
                          else 4)
    return torch.empty(n, dtype=torch.uint8, device=args["caps"].device)


def phase_waterfill_global(shapes, dev, errs):
    """The water-filling kernel's device-memory variant against the plain
    version: f64 bit for bit, f32 within 1e-5, at the Fig. 6 sim's shape
    and at the fleet's, twice what one block's shared memory takes, where
    the shared-memory entry must raise."""
    from repro_torch.kernels.waterfill import ops

    fleet = wf_inputs(shapes["fleet"], dev, torch.float64)
    nc, nv = fleet["caps"].shape[0], fleet["eg_cap"].shape[0]
    ne = fleet["ed_cap"].shape[0]
    check(ops.lanes_in_device_memory(nc, nv, ne),
          "the fleet's lanes fit one block's shared memory")
    try:
        ops.waterfill_rates(**fleet)
        check(False, "the shared-memory entry took the fleet's solve")
    except ValueError:
        pass
    n = 0
    for label, su in shapes.items():
        for seed in range(2):
            for precision, dtype in (("f64", torch.float64),
                                     ("f32", torch.float32)):
                args = wf_inputs(su, dev, dtype, seed=seed)
                got = ops.waterfill_rates(**args, precision=precision,
                                          lanes=wf_lanes(args, precision))
                want = ops.waterfill_rates(**to_cpu(args),
                                           precision=precision)
                got = got.cpu()
                name = f"waterfill_{precision}_global"
                errs[name] = max(errs.get(name, 0.0),
                                 float((got - want).abs().max()))
                if precision == "f64":
                    check(torch.equal(got, want), f"f64 device-memory "
                          f"variant != plain ({label}, seed {seed})")
                else:
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=1e-5)
                n += 1
    say("waterfill_global", cases=n, f64_bitwise=True, fleet_lanes=nc,
        fleet_vms=nv, fleet_smem_bytes=ops.smem_bytes(nc, nv, ne, 8),
        smem_limit=ops.SMEM_LIMIT, shared_entry_raised=True,
        max_abs_err={k: v for k, v in errs.items() if "global" in k})


def phase_plan(top):
    from repro_torch.core import Planner, PlanSpec, direct_plan
    from repro_torch.core.solver import ipm_batch

    ceiling = direct_plan(top, SRC, DST, FIG6_VOLUME_GB).cost_per_gb * 1.15

    def spec(backend):
        return PlanSpec(
            objective="tput_max", src=SRC, dst=DST,
            cost_ceiling_per_gb=ceiling, volume_gb=FIG6_VOLUME_GB,
            n_samples=8, backend=backend,
        )

    res0, smp0 = ipm_batch._resolves.value, ipm_batch._batched_samples.value
    t0 = time.perf_counter()
    card = Planner(top).plan(spec("torch"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    resolves = ipm_batch._resolves.value - res0
    samples = ipm_batch._batched_samples.value - smp0
    numpy_plan = Planner(top).plan(spec("numpy"))
    cpu_plan = Planner(top, device="cpu").plan(spec("torch"))
    check(card.validate() == [] and numpy_plan.validate() == [],
          "plan does not validate")
    check(np.array_equal(card.N, numpy_plan.N), "N differs from numpy")
    check(abs(card.cost_per_gb - numpy_plan.cost_per_gb) <= 1e-6,
          "cost differs from numpy")
    check(abs(card.tput_goal - numpy_plan.tput_goal)
          <= 1e-6 * numpy_plan.tput_goal, "throughput differs from numpy")
    check(resolves < samples, "every batched sample was re-solved")
    # M is not unique (connections carry no cost): the card must land on
    # the M the same torch IPM picks on the CPU
    check(np.array_equal(card.N, cpu_plan.N)
          and np.array_equal(card.M, cpu_plan.M),
          "card plan differs from the CPU torch plan")
    say("plan", wall_s=round(wall, 4), tput_gbps=card.tput_goal,
        cost_per_gb=card.cost_per_gb,
        cost_diff_vs_numpy=card.cost_per_gb - numpy_plan.cost_per_gb,
        n_equal_numpy=True,
        m_equal_numpy=bool(np.array_equal(card.M, numpy_plan.M)),
        nm_equal_cpu_torch=True, resolves=int(resolves),
        batched_samples=int(samples))
    return card


def fig6_jobs(top, plan):
    from repro_torch.core import direct_plan
    from repro_torch.transfer import (GrayFailure, LinkDegrade, LinkRestore,
                                      TransferJob, VMFailure)

    jobs = [
        TransferJob(plan, "fig6", chunk_mb=CHUNK_MB),
        TransferJob(direct_plan(top, SRC, DST, 64.0, num_vms=2), "late",
                    arrival_s=60.0, chunk_mb=CHUNK_MB),
    ]
    path, _ = max(plan.paths(), key=lambda pf: pf[1])
    first, last = (path[0], path[1]), (path[-2], path[-1])
    faults = [
        LinkDegrade(t_s=100.0, src=first[0], dst=first[1], factor=0.5),
        GrayFailure(t_s=200.0, src=last[0], dst=last[1], factor=0.6),
        VMFailure(t_s=300.0, job=0, region=plan.src, count=1),
        LinkRestore(t_s=400.0, src=first[0], dst=first[1], factor=2.0),
    ]
    return jobs, faults


def traced_sim(jobs, faults, **kw):
    """(result, wall seconds, Skytrace events) of one run."""
    from repro_torch.obs import trace
    from repro_torch.transfer import simulate

    tr = trace.enable(capacity=1 << 20)
    try:
        t0 = time.perf_counter()
        res = simulate(jobs, faults, **kw)
        if kw.get("device") != "cpu":
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0, tr.events()
    finally:
        trace.disable()


SIM_BLOCK = 64  # simulate_multi_torch's default block: one graph's length


def graph_counts() -> dict:
    """The sim's CUDA-graph counters: graphs captured, seconds of capture
    and instantiation, replays, and predicated iterations run."""
    from repro_torch.obs.metrics import REGISTRY

    return {k: REGISTRY.counter(f"sim.{k}").value for k in (
        "graph_captures", "graph_capture_s", "graph_replays", "iterations")}


def graph_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in graph_counts().items()}


def same_run(card, cpu, what: str) -> None:
    check(card.events == cpu.events and card.time_s == cpu.time_s,
          f"{what}: card and CPU runs differ in events or time")
    for a, b in zip(card.jobs, cpu.jobs):
        check(dataclasses.asdict(a) == dataclasses.asdict(b),
              f"{what}: card and CPU results differ for job {a.name}")


def phase_sim(jobs, faults):
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.transfer.flowsim_torch import simulate_multi_torch

    seq = REGISTRY.counter("sim.seq_cascades")
    g0 = graph_counts()
    card, wall, card_tr = traced_sim(jobs, faults)
    graphs = graph_delta(g0)
    cpu, cpu_wall, cpu_tr = traced_sim(jobs, faults, device="cpu")
    same_run(card, cpu, "fig6")
    check(card_tr == cpu_tr, "card and CPU Skytrace streams differ")
    check(all(j.status == "done" for j in card.jobs), "a job did not finish")
    # a multicast job through relays with a relay buffer of one chunk:
    # the host-side sequential cascade fires on most iterations
    mc_jobs, mc_faults = relay_jobs(jobs[0].plan.top)
    seq0, g0 = seq.value, graph_counts()
    tight, tight_wall, _ = traced_sim(mc_jobs, mc_faults,
                                      relay_buffer_chunks=1)
    fired = seq.value - seq0
    tight_graphs = graph_delta(g0)
    tight_cpu, _, _ = traced_sim(mc_jobs, mc_faults, device="cpu",
                                 relay_buffer_chunks=1)
    same_run(tight, tight_cpu, "multicast, relay_buffer_chunks=1")
    check(fired > 0, "the sequential cascade never fired")
    check(graphs["graph_captures"] > 0 and tight_graphs["graph_captures"] > 0,
          "the card's sim captured no CUDA graph")
    check(card.jobs[0].n_chunks == 10_240, "the Fig. 6 job is not 10,240")
    check(sum(j.retried_chunks for j in card.jobs) > 0,
          "the VM failure forced no retries")
    f32 = simulate_multi_torch(jobs, faults, rate_solver="f32")
    torch.cuda.synchronize()
    check([j.chunks_delivered for j in f32.jobs]
          == [j.chunks_delivered for j in card.jobs], "f32 run lost chunks")
    say("sim", chunks=[j.n_chunks for j in card.jobs], events=card.events,
        sim_time_s=card.time_s, wall_s=round(wall, 4),
        events_per_s=round(card.events / wall, 1),
        cpu_wall_s=round(cpu_wall, 4), asdict_equal_cpu=True,
        trace_equal_cpu=True, trace_events=len(card_tr),
        retried=[j.retried_chunks for j in card.jobs],
        graphs=graphs, relay1_events=tight.events,
        relay1_seq_cascades=int(fired), relay1_wall_s=round(tight_wall, 4),
        relay1_graphs=tight_graphs,
        f32_sim_time_s=f32.time_s, f32_events=f32.events)


def relay_jobs(top):
    """The reference's multicast-plus-unicast sim scenario: a three-way
    replication through relays and a delayed unicast job, one VM failure."""
    from repro_torch.core import Planner, PlanSpec, direct_plan
    from repro_torch.transfer import TransferJob, VMFailure

    mc = Planner(top, max_relays=6).plan(PlanSpec(
        objective="cost_min", src="gcp:us-central1",
        dsts=("gcp:europe-west1", "gcp:europe-west3", "gcp:europe-west4"),
        tput_goal_gbps=2.0, volume_gb=1.0,
    ))
    jobs = [
        TransferJob(mc, "repl"),
        TransferJob(direct_plan(top, BIG_SRC, BIG_DST, 0.5, num_vms=2),
                    "uni", arrival_s=0.5),
    ]
    kill = next(int(r) for r in mc.dsts if mc.N[r] >= 1)
    return jobs, [VMFailure(t_s=0.8, job=0, region=kill, count=1)]


def fleet_jobs(top):
    """FLEET_JOBS staggered direct jobs of 8 VMs x 64 connections and
    FLEET_CHUNKS chunks each, over FLEET_ROUTES."""
    from repro_torch.core import direct_plan
    from repro_torch.transfer import TransferJob

    return [TransferJob(
        direct_plan(top, *FLEET_ROUTES[i % 3],
                    FLEET_CHUNKS * FLEET_CHUNK_MB / 1024, num_vms=8),
        f"fleet{i}", chunk_mb=FLEET_CHUNK_MB, arrival_s=0.01 * i)
        for i in range(FLEET_JOBS)]


def phase_sim_fleet(top):
    """The fleet on the card, every solve past one block's shared memory:
    held field for field, Skytrace stream and all, against its CPU run;
    every water-filling launch takes the device-memory variant."""
    from repro_torch.kernels.waterfill import ops
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.transfer.events import materialize_jobs

    jobs = fleet_jobs(top)
    su = materialize_jobs(jobs)
    nc = -(-su.conn_job.shape[0] // 8) * 8
    nv, ne = su.vm_eg_cap.shape[0], len(su.edges_used)
    check(ops.lanes_in_device_memory(nc, nv, ne),
          "the fleet's solves fit one block's shared memory")
    glob = REGISTRY.counter("kernels.waterfill_f64_global.launches")
    shared = REGISTRY.counter("kernels.waterfill_f64.launches")
    n0, s0, g0 = glob.value, shared.value, graph_counts()
    card, wall, card_tr = traced_sim(jobs, [])
    graphs = graph_delta(g0)
    launches, shared_launches = glob.value - n0, shared.value - s0
    cpu, cpu_wall, cpu_tr = traced_sim(jobs, [], device="cpu")
    same_run(card, cpu, "fleet")
    check(card_tr == cpu_tr, "fleet: card and CPU Skytrace streams differ")
    check(all(j.status == "done" for j in card.jobs), "a fleet job failed")
    iterations = graphs["iterations"]
    check(launches == iterations and shared_launches == 0,
          f"fleet: {launches} device-memory and {shared_launches} "
          f"shared-memory solves over {iterations} iterations")
    say("sim_fleet", jobs=len(jobs), lanes=nc, vms=nv, edges=ne,
        smem_bytes_all_shared=ops.smem_bytes(nc, nv, ne, 8),
        smem_limit=ops.SMEM_LIMIT, events=card.events,
        sim_time_s=card.time_s, wall_s=round(wall, 4),
        events_per_s=round(card.events / wall, 1),
        cpu_wall_s=round(cpu_wall, 4), asdict_equal_cpu=True,
        trace_equal_cpu=True, waterfill_global_launches=int(launches),
        graphs=graphs)


def big_jobs(top):
    from repro_torch.core import direct_plan
    from repro_torch.transfer import TransferJob

    volume = BIG_CHUNKS * CHUNK_MB / 1024
    return [TransferJob(
        direct_plan(top, BIG_SRC, BIG_DST, volume, num_vms=2), "1e5",
        chunk_mb=CHUNK_MB,
    )]


@contextlib.contextmanager
def timed_blocks():
    """CUDA events on the sim's stream around every block of iterations it
    runs (a graph replay, or the eager first use of a block length);
    yields the list of (start, end) event pairs."""
    from repro_torch.transfer import flowsim_torch

    spans, run = [], flowsim_torch._Blocks.run

    def timed(self, n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run(self, n)
        b.record()
        spans.append((a, b))

    flowsim_torch._Blocks.run = timed
    try:
        yield spans
    finally:
        flowsim_torch._Blocks.run = run


def phase_sim_1e5(jobs):
    """The 1e5-chunk sim on the card. Each block of iterations is
    bracketed by CUDA events, so the card's busy time is the sum of the
    blocks' spans on its own clock, in this run: the idle share is the
    rest of the run's wall (set-up, the host's flag reads, scripted
    events and sequential cascades between blocks), and the loop's idle
    share the rest of the span from the first block's start to the last
    block's end. A span counts a graph's gaps between its kernels as
    busy, so both shares are what the host leaves the card idle."""
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.transfer import simulate

    wf = REGISTRY.counter("kernels.waterfill_f64.launches")
    ss = REGISTRY.counter("kernels.segsum_ordered.launches")
    n0, s0, g0 = wf.value, ss.value, graph_counts()
    with timed_blocks() as spans:
        t0 = time.perf_counter()
        res = simulate(jobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    graphs = graph_delta(g0)
    busy_ms = sum(a.elapsed_time(b) for a, b in spans)
    loop_ms = spans[0][0].elapsed_time(spans[-1][1])
    job = res.jobs[0]
    check(job.status == "done" and job.chunks_delivered == BIG_CHUNKS,
          "the 1e5-chunk job did not deliver every chunk")
    launches = int(wf.value - n0)
    check(launches >= res.events and launches == graphs["iterations"],
          "water-filling launches are not one per iteration run")
    check(graphs["graph_replays"] > 0, "the sim replayed no CUDA graph")
    say("sim_1e5", chunks=job.n_chunks, events=res.events,
        sim_time_s=res.time_s, wall_s=round(wall, 3),
        events_per_s=round(res.events / wall, 1),
        waterfill_launches=launches, segsum_launches=int(ss.value - s0),
        graphs=graphs, blocks=len(spans), blocks_device_s=busy_ms / 1e3,
        device_us_per_iteration=busy_ms * 1e3 / graphs["iterations"],
        loop_s=loop_ms / 1e3, device_idle_share=1.0 - busy_ms / 1e3 / wall,
        device_idle_share_loop=1.0 - busy_ms / loop_ms)


# --------------------------------------------------------------- service
def plan_record(p) -> dict:
    return {"status": p.solver_status, "N": np.asarray(p.N).tolist(),
            "M": np.asarray(p.M).tolist(), "F": np.asarray(p.F).tolist()}


def replan_record(r) -> dict:
    """A ``ReplanRecord`` but its wall-clock ``latency_s``."""
    return {**{f.name: getattr(r, f.name) for f in dataclasses.fields(r)
               if f.name not in ("latency_s", "plan")},
            "plan": plan_record(r.plan)}


def service_record(svc, rep) -> dict:
    """Everything a service run decides: ``ServiceReport.to_dict()``
    without its ``metrics`` section (the registry is process-wide), every
    ``ReplanRecord`` but its wall-clock ``latency_s``, the breaker's
    transitions, each job's final plan and the service's degraded and
    gray views. A calibrated run adds every probe round, drift event and
    epoch roll, the belief-error trajectory, the segment boundaries and
    the final belief; a fleet's ``to_dict()`` carries each tenant's
    ``TenantReport.to_dict()`` and ``deferred_jobs``."""
    d = rep.to_dict()
    d.pop("metrics", None)
    d["replan_records"] = [replan_record(r) for r in rep.replans]
    d["transitions"] = [dataclasses.asdict(t) for t in rep.quarantines]
    d["final_plans"] = [plan_record(j.plan) for j in rep.jobs]
    d["degraded_links"] = sorted(svc.degraded_links.items())
    d["gray"] = sorted(svc._gray.items())
    if hasattr(rep, "probe_rounds"):
        d["probe_round_records"] = [dataclasses.asdict(r)
                                    for r in rep.probe_rounds]
        d["drift_event_records"] = [dataclasses.asdict(e)
                                    for e in rep.drift_events]
        d["epoch_roll_records"] = [
            {"t_s": r.t_s, "ratio": r.ratio,
             "structure_builds": r.structure_builds,
             "replans": [replan_record(x) for x in r.replans]}
            for r in rep.epoch_rolls]
        d["belief_error_trajectory"] = [
            list(x) for x in rep.belief_error_trajectory]
        d["boundaries"] = list(rep.boundaries)
        bel = svc.belief
        d["belief"] = {"mean": bel.mean.tolist(), "count": bel.count.tolist(),
                       "m2": bel.m2.tolist(),
                       "last_obs_t": bel.last_obs_t.tolist(),
                       "version": bel.version, "epoch": bel.epoch}
    return d


def first_difference(a, b, path="report"):
    """Where two records first differ, with both values, or None."""
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return f"{path}: keys {sorted(a)} != {sorted(b)}"
        for k in a:
            d = first_difference(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return f"{path}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_difference(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r} != {b!r}"


def timed_run(svc, **kw) -> tuple:
    """(service, its report, the run's wall seconds)."""
    t0 = time.perf_counter()
    rep = svc.run(**kw)
    if svc.device != "cpu":
        torch.cuda.synchronize()
    return svc, rep, time.perf_counter() - t0


def multijob_service(top, **svc_kw):
    """``benchmarks/multijob_bench.py``'s service block (:24-37, :63-66) at
    the [sim] phase's chunk count: three jobs of SERVICE_VOLUME_GB in
    64 MB chunks, a link degrade at 2 s and a VM failure at 4 s."""
    from repro_torch.transfer import (LinkDegrade, TransferRequest,
                                      TransferService, VMFailure)

    svc = TransferService(top, max_relays=6, **svc_kw)
    for name, src, arrival in (("a", SRC, 0.0), ("b", SRC, 1.0),
                               ("c", SERVICE_SRC2, 0.0)):
        svc.submit(TransferRequest(name, src, DST, SERVICE_VOLUME_GB,
                                   SERVICE_GOAL_GBPS, arrival_s=arrival,
                                   chunk_mb=CHUNK_MB))
    s, d = top.index(SRC), top.index(DST)
    faults = [LinkDegrade(t_s=2.0, src=s, dst=d, factor=0.5),
              VMFailure(t_s=4.0, job=0, region=s, count=1)]
    return [timed_run(svc, faults=faults, link_capacity_scale=0.8)]


def chaos_suite(top, **svc_kw):
    """``benchmarks/chaos_bench.py``'s ``_run_suite`` (:20-64) at its full
    size: CHAOS_SEEDS, the breaker-and-budget arm, then the baseline."""
    from repro_torch.transfer import (BreakerConfig, ChaosScenario,
                                      DegradationLadder, LinkBreaker,
                                      TransferRequest, TransferService)

    s, d = top.index(CHAOS_SRC), top.index(CHAOS_DST)
    s2 = top.index(CHAOS_SRC2)
    out = []
    for with_breaker in (True, False):
        for seed in CHAOS_SEEDS:
            sc = ChaosScenario(top, seed=seed, horizon_s=6.0, n_brownouts=1,
                               n_gray=1, n_flapping=1, flap_count=(8, 12),
                               flap_period_s=(2.0, 3.0),
                               links=[(s, d), (s2, d)])
            br = (LinkBreaker(BreakerConfig(k=3, window_s=20.0,
                                            cooldown_s=8.0))
                  if with_breaker else None)
            svc = TransferService(
                top, max_relays=6, breaker=br,
                degradation=DegradationLadder(pressure=0.25), **svc_kw)
            budget = 10_000 if with_breaker else None
            for name, src, arrival in (("a", CHAOS_SRC, 0.0),
                                       ("b", CHAOS_SRC2, 1.0)):
                svc.submit(TransferRequest(
                    name, src, CHAOS_DST, CHAOS_VOLUME_GB, 2.0,
                    arrival_s=arrival, deadline_s=40.0, retry_budget=budget))
            out.append(timed_run(svc, faults=sc.events(2)))
    return out


def phase_service(name, suite, top, counters, extra=None,
                  cpu_suite=None) -> list:
    """One service configuration on the card (``backend="torch"``,
    ``engine="torch"``, the card by default) and on the CPU
    (``backend="torch"``, ``device="cpu"``, ``engine="soa"``), held equal
    run for run by ``service_record``. Every block of the card's sim
    iterations is bracketed by CUDA events, as in [sim_1e5]: the idle
    share is the rest of the card run's wall, so it counts the planner's
    torch IPM on the card as idle. ``extra(reports)`` checks what the
    configuration's benchmark asserts and returns more fields to print.
    ``cpu_suite`` (default ``suite``) may run the first of the card's
    runs alone on the CPU; the rest are then checked for lost chunks and
    launches only. Returns the card run's reports."""
    from repro_torch.obs.metrics import REGISTRY

    before = {k: REGISTRY.counter(c).value for k, c in counters.items()}
    g0 = graph_counts()
    with timed_blocks() as spans:
        t0 = time.perf_counter()
        card = suite(top, backend="torch", engine="torch")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    graphs = graph_delta(g0)
    launches = {k: int(REGISTRY.counter(c).value - before[k])
                for k, c in counters.items()}
    busy_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    t0 = time.perf_counter()
    cpu = (cpu_suite or suite)(top, backend="torch", device="cpu",
                               engine="soa")
    cpu_wall = time.perf_counter() - t0
    check(len(cpu) == len(card) if cpu_suite is None
          else 0 < len(cpu) < len(card), f"{name}: run counts differ")
    for i, ((cs, cr, _), (ps, pr, _)) in enumerate(zip(card, cpu)):
        diff = first_difference(service_record(cs, cr),
                                service_record(ps, pr))
        check(diff is None, f"{name}: run {i}: card != CPU at {diff}")
    reps = [r for _, r, _ in card]
    jobs = [j for r in reps for j in r.jobs]
    lost = sum(j.lost_chunks for j in jobs)
    check(lost == 0, f"{name}: {lost} chunks lost")
    events = sum(r.sim_events for r in reps)
    replans = [x for r in reps for x in r.replans]
    wf = sum(n for k, n in launches.items() if k.startswith("waterfill"))
    check(wf > 0 and launches["segsum_ordered_f64"] > 0,
          f"{name}: the sim's kernels were not launched: {launches}")
    say(name, runs=len(reps), cpu_runs=len(cpu), jobs=len(jobs),
        chunks=sum(j.n_chunks for j in jobs), wall_s=wall,
        cpu_wall_s=cpu_wall, segments=sum(r.segments for r in reps),
        sim_events=events, sim_events_per_s=events / wall,
        cpu_sim_events_per_s=sum(r.sim_events for _, r, _ in cpu) / cpu_wall,
        run_walls_s=[w for _, _, w in card],
        cpu_run_walls_s=[w for _, _, w in cpu], replans=len(replans),
        replan_latency_ms_median=float(np.median(
            [x.latency_s for x in replans])) * 1e3 if replans else None,
        graph_captures=graphs["graph_captures"],
        graph_capture_s=graphs["graph_capture_s"],
        graph_replays=graphs["graph_replays"],
        sim_iterations=graphs["iterations"], blocks=len(spans),
        blocks_device_s=busy_s, device_idle_share=1.0 - busy_s / wall,
        launches=launches, equal_cpu=True,
        not_compared=["ReplanRecord.latency_s", "to_dict()['metrics']"],
        done=sum(j.status == "done" for j in jobs),
        slo_violations=sum(j.deadline_met is False for j in jobs),
        quarantines=sum(len(r.quarantines) for r in reps), lost_chunks=lost,
        **(extra(reps) if extra else {}))
    return reps


def service_path(top, counters) -> dict:
    """The transfer service on the card: each configuration's reports."""
    return {"service": phase_service("service", multijob_service, top,
                                     counters),
            "service_chaos": phase_service("service_chaos", chaos_suite, top,
                                           counters)}


# --------------------------------------------------------- calibrated path
def widest_edge(top, src, dst, volume_gb=4.0) -> tuple[int, int]:
    """The widest edge of the 4 Gbps cost-min plan of a ``volume_gb``
    transfer on the route (the numpy planner): where the benchmarks'
    incident lands."""
    from repro_torch.core import Planner, PlanSpec

    plan = Planner(top, max_relays=6).plan(PlanSpec(
        objective="cost_min", src=src, dst=dst, tput_goal_gbps=4.0,
        volume_gb=volume_gb))
    a, b = np.unravel_index(int(np.argmax(plan.F)), plan.F.shape)
    return int(a), int(b)


def achieved_gbps(rep) -> float:
    return sum(j.delivered_gb for j in rep.jobs) * 8.0 / max(rep.time_s,
                                                             1e-9)


def replan_builds(rep) -> int:
    return sum(r.structure_builds for j in rep.jobs for r in j.replans)


def probe_fields(reps) -> dict:
    """What the calibration plane spent and found, over a phase's runs."""
    return dict(
        probe_rounds=sum(len(r.probe_rounds) for r in reps),
        probe_cost_usd=sum(r.probe_cost_usd for r in reps),
        probe_seconds=sum(r.probe_seconds for r in reps),
        drift_events=sum(len(r.drift_events) for r in reps),
        epoch_rolls=sum(len(r.epoch_rolls) for r in reps),
        epoch_roll_builds=sum(r.epoch_roll_builds for r in reps),
        replan_struct_builds=sum(replan_builds(r) for r in reps))


def calibrated_suite(top, **svc_kw):
    """``benchmarks/calibration_bench.py``'s two arms (:29-70) at its full
    size: the calibrated service, then the stale baseline."""
    from repro_torch.calibrate import (CalibratedTransferService,
                                       DriftModel, Incident)
    from repro_torch.transfer import TransferRequest

    a, b = widest_edge(top, CAL_SRC, CAL_DST)
    drift = DriftModel(top, seed=0, drift_sigma=0.10, diurnal_amp=0.0,
                       incidents=[Incident(src=a, dst=b, t_start_s=6.0,
                                           duration_s=1e9, severity=0.08)])
    out = []
    for calibrate in (True, False):
        svc = CalibratedTransferService(
            drift, max_relays=6, calibrate=calibrate, check_interval_s=4.0,
            max_segments=CAL_SEGMENTS, **svc_kw)
        svc.submit(TransferRequest("bench", CAL_SRC, CAL_DST, CAL_VOLUME_GB,
                                   CAL_GOAL_GBPS))
        out.append(timed_run(svc))
    return out


def calibrated_extra(reps) -> dict:
    cal, stale = reps
    check(cal.drift_events, "[calibrated]: the incident went undetected")
    check(replan_builds(cal) == 0,
          "[calibrated]: a robust re-plan re-assembled an LP structure")
    ratio = achieved_gbps(cal) / max(achieved_gbps(stale), 1e-9)
    check(ratio >= 1.5, f"[calibrated]: calibrated/stale {ratio} < 1.5")
    return dict(**probe_fields([cal]), replans_calibrated=len(cal.replans),
                achieved_gbps={"calibrated": achieved_gbps(cal),
                               "stale": achieved_gbps(stale)},
                achieved_ratio_vs_stale=ratio)


def probe_race_suite(top, **svc_kw):
    """``benchmarks/probe_policy_bench.py``'s service race (:142-188),
    each of PROBE_POLICIES at full volume, then its epoch-roll scenario
    (:191-245), rolls on (2) and off (0)."""
    from repro_torch.calibrate import (BeliefGrid, CalibratedTransferService,
                                       Calibrator, DriftModel, Incident,
                                       ProbeBudget, make_policy)
    from repro_torch.core import Planner
    from repro_torch.transfer import TransferRequest

    incidents = []
    for i, (src, dst) in enumerate(PROBE_CONTEXTS):
        a, b = widest_edge(top, src, dst, volume_gb=8.0)
        incidents.append(Incident(src=a, dst=b, t_start_s=5.0 + 6.0 * i,
                                  duration_s=1e9, severity=0.10 + 0.05 * i))
    drift = DriftModel(top, seed=3, drift_sigma=0.20, diurnal_amp=0.0,
                       incidents=incidents)

    def prewarmed(links):
        bel, truth0 = BeliefGrid(top), drift.tput_at(0.0)
        for a, b in links:
            bel.observe_adaptive(a, b, float(truth0[a, b]), weight=4.0,
                                 t_s=0.0)
        return bel

    candidates = Calibrator(prewarmed([])).candidate_links(
        Planner(top, max_relays=6), PROBE_CONTEXTS)
    out = []
    for pol in PROBE_POLICIES:
        bel = prewarmed(candidates)
        svc = CalibratedTransferService(
            drift, belief=bel, calibrator=Calibrator(
                bel, policy=make_policy(pol, seed=7),
                budget=ProbeBudget(usd_per_round=0.9, seconds_per_round=20.0,
                                   max_probes_per_round=3)),
            max_relays=6, check_interval_s=4.0, max_segments=150, **svc_kw)
        for i, (src, dst) in enumerate(PROBE_CONTEXTS):
            svc.submit(TransferRequest(f"job{i}", src, dst, PROBE_VOLUME_GB,
                                       4.0))
        out.append(timed_run(svc))
    src, dst = PROBE_CONTEXTS[0]
    s = top.index(src)
    roll_drift = DriftModel(top, seed=0, drift_sigma=0.02, diurnal_amp=0.0)
    for max_rolls in (2, 0):
        bel = BeliefGrid(top)
        for b in range(top.num_regions):
            if b != s and top.tput[s, b] > 0:
                bel.reset_link(s, b, 0.05 * top.tput[s, b])
        svc = CalibratedTransferService(
            roll_drift, belief=bel, max_relays=6, check_interval_s=4.0,
            policy="round_robin", max_epoch_rolls=max_rolls, max_segments=150,
            **svc_kw)
        svc.submit(TransferRequest("roll", src, dst, ROLL_VOLUME_GB, 4.0))
        out.append(timed_run(svc))
    return out


def probe_race_extra(reps) -> dict:
    race, (rolled, capped) = reps[:len(PROBE_POLICIES)], reps[-2:]
    for pol, rep in zip(PROBE_POLICIES, race):
        check(replan_builds(rep) == 0,
              f"[probe_race] {pol}: a drift re-plan re-assembled an LP")
    check(1 <= len(rolled.epoch_rolls) <= 2 and not capped.epoch_rolls,
          f"[probe_race]: {len(rolled.epoch_rolls)} epoch rolls")
    check(all(any(abs(r.t_s - b) < 1e-9 for b in rolled.boundaries)
              for r in rolled.epoch_rolls),
          "[probe_race]: an epoch roll fired mid-segment")
    gain = achieved_gbps(rolled) / max(achieved_gbps(capped), 1e-9)
    check(gain >= 1.02, f"[probe_race]: the epoch roll did not pay: {gain}")
    tput = {p: achieved_gbps(r) for p, r in zip(PROBE_POLICIES, race)}
    return dict(**probe_fields(reps), achieved_gbps=tput,
                evoi_vs_greedy_tput=tput["evoi"] / max(tput["greedy"], 1e-9),
                epoch_roll_achieved_gbps=achieved_gbps(rolled),
                noroll_achieved_gbps=achieved_gbps(capped),
                epoch_roll_gain_x=gain,
                epoch_roll_struct_builds=rolled.epoch_roll_builds)


def fleet_world(top):
    """``benchmarks/fleet_bench.py``'s world (:32-88) at its full size:
    the drift model's factory, the three tenants and each tenant's job
    requests (as keyword dicts: admission rewrites a request's goal and
    arrival)."""
    from repro_torch.calibrate import DriftModel, Incident
    from repro_torch.transfer import TenantSpec

    a, b = widest_edge(top, CAL_SRC, CAL_DST)

    def make_drift():
        return DriftModel(top, seed=0, drift_sigma=0.10, diurnal_amp=0.0,
                          incidents=[Incident(src=a, dst=b, t_start_s=6.0,
                                              duration_s=1e9, severity=0.08)])

    tenants = [TenantSpec("analytics", weight=1.0, vm_quota=4),
               TenantSpec("backup", weight=1.0, vm_quota=4),
               TenantSpec("ml-sync", weight=2.0, slo_class="deadline",
                          vm_quota=4)]
    slack_s = 30.0 + 15.0 * (TENANT_JOBS - 2)
    jobs = {}
    for ti, spec in enumerate(tenants):
        src = TENANT_SRC2 if spec.name == "backup" else CAL_SRC
        jobs[spec.name] = []
        for j in range(TENANT_JOBS):
            vol = TENANT_SIZES_GB[(ti + j) % len(TENANT_SIZES_GB)]
            jobs[spec.name].append(dict(
                name=f"{spec.name}-{j}", src=src, dst=CAL_DST, volume_gb=vol,
                tput_goal_gbps=2.0, chunk_mb=TENANT_CHUNK_MB,
                arrival_s=j * TENANT_STAGGER_S,
                deadline_s=(vol * 8.0 / 2.0 + slack_s
                            if spec.slo_class == "deadline" else None)))
    return make_drift, tenants, jobs


def fleet_controller(top, make_drift, tenants, jobs, **kw):
    from repro_torch.transfer import FleetController, TransferRequest

    fleet = FleetController(make_drift(), tenants=tenants, **kw)
    for spec in tenants:
        for j in jobs[spec.name]:
            fleet.submit(TransferRequest(**j), tenant=spec.name)
    return fleet


def fleet_suite(top, isolated=True, **svc_kw):
    """``benchmarks/fleet_bench.py``'s arms (:90-135): the fleet, then
    (``isolated``) each tenant's isolated calibrated service at its
    quota."""
    from repro_torch.calibrate import CalibratedTransferService
    from repro_torch.transfer import TransferRequest

    make_drift, tenants, jobs = fleet_world(top)
    kw = dict(max_relays=6, check_interval_s=4.0, max_segments=150, **svc_kw)
    fleet = fleet_controller(top, make_drift, tenants, jobs,
                             probe_dedup_window_s=3.0, **kw)
    out = [timed_run(fleet)]
    for spec in tenants if isolated else ():
        svc = CalibratedTransferService(make_drift(), vm_budget=spec.vm_quota,
                                        **kw)
        for j in jobs[spec.name]:
            svc.submit(TransferRequest(**j))
        out.append(timed_run(svc))
    return out


def fleet_extra(reps) -> dict:
    """``benchmarks/fleet_bench.py``'s metrics (:136-162) and asserts."""
    fleet, iso = reps[0], reps[1:]

    def latencies(jobs):
        return [j.delivered_gb * 8.0 / max(j.realized_tput_gbps, 1e-9)
                for j in jobs if j.delivered_gb > 0]

    def p99(xs):
        return float(np.percentile(xs, 99)) if xs else 0.0

    iso_gb = sum(j.delivered_gb for r in iso for j in r.jobs)
    fleet_gb = sum(j.delivered_gb for j in fleet.jobs)
    iso_tput = iso_gb * 8.0 / max(max(r.time_s for r in iso), 1e-9)
    iso_lat = [x for r in iso for x in latencies(r.jobs)]
    check(fleet_gb >= iso_gb - 1e-6,
          f"[fleet_service]: fleet delivered {fleet_gb} < isolated {iso_gb}")
    check(replan_builds(fleet) == 0,
          "[fleet_service]: a fleet re-plan re-assembled an LP structure")
    return dict(
        **probe_fields([fleet]),
        agg_tput_ratio_vs_isolated=achieved_gbps(fleet) / max(iso_tput,
                                                              1e-9),
        p99_job_latency_ratio=p99(latencies(fleet.jobs)) / max(p99(iso_lat),
                                                               1e-9),
        probe_cost_per_tenant_ratio=fleet.probe_cost_usd / max(
            sum(r.probe_cost_usd for r in iso), 1e-9),
        fleet_agg_gbps=achieved_gbps(fleet), isolated_agg_gbps=iso_tput,
        deferred_jobs=fleet.deferred_jobs,
        deadline_misses=sum(t.deadline_misses for t in fleet.tenants),
        quota_borrows=sum(t.quota_borrows for t in fleet.tenants),
        fleet_time_s=fleet.time_s, isolated_time_s=[r.time_s for r in iso])


def phase_fleet_cohort(top) -> None:
    """The fleet's batched cohort admission (``benchmarks/fleet_bench.py``
    :164-182) on the card's torch IPM and on the CPU's: the 24 admitted
    states' plans equal, and no more LP structure builds than routes."""
    from repro_torch.core import milp

    make_drift, tenants, jobs = fleet_world(top)
    routes = {(j["src"], j["dst"]) for t in tenants for j in jobs[t.name]}
    out = {}
    for side, kw in (("card", {}), ("cpu", {"device": "cpu"})):
        fleet = fleet_controller(top, make_drift, tenants, jobs,
                                 backend="torch", max_relays=6,
                                 check_interval_s=4.0, max_segments=150, **kw)
        b0 = milp.N_STRUCT_BUILDS
        t0 = time.perf_counter()
        states = fleet._admit_queue()
        if side == "card":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        builds = milp.N_STRUCT_BUILDS - b0
        check(builds <= len(routes) and all(
            st.status == "planned" for st in states),
            f"[fleet_cohort] {side}: {builds} builds for {len(routes)} routes")
        out[side] = (states, builds, wall)
    card, cpu = out["card"][0], out["cpu"][0]
    diff = first_difference(
        [(st.req.name, st.req.tput_goal_gbps, plan_record(st.plan))
         for st in card],
        [(st.req.name, st.req.tput_goal_gbps, plan_record(st.plan))
         for st in cpu])
    check(diff is None, f"[fleet_cohort]: card != CPU at {diff}")
    say("fleet_cohort", states=len(card), routes=len(routes),
        struct_builds=out["card"][1], admit_s=out["card"][2],
        cpu_admit_s=out["cpu"][2], equal_cpu=True)


def calibrated_path(top, counters) -> dict:
    """The calibration plane and the fleet controller on the card: each
    configuration's reports."""
    reps = {
        "calibrated": phase_service("calibrated", calibrated_suite, top,
                                    counters, calibrated_extra),
        "probe_race": phase_service("probe_race", probe_race_suite, top,
                                    counters, probe_race_extra),
        "fleet_service": phase_service(
            "fleet_service", fleet_suite, top, counters, fleet_extra,
            cpu_suite=functools.partial(fleet_suite, isolated=False)),
    }
    phase_fleet_cohort(top)
    return reps


def phase_service_kernels(reps: dict, dev, errs) -> None:
    """The sim's kernels against their plain versions again, at the
    service's shapes: each configuration's final plans at full volume."""
    from repro_torch.kernels.waterfill import ops
    from repro_torch.transfer import TransferJob
    from repro_torch.transfer.events import materialize_jobs

    shapes = {}
    for label, runs in reps.items():
        rep = runs[0]
        jobs = [TransferJob(j.plan.with_volume(j.request.volume_gb),
                            j.request.name, arrival_s=j.request.arrival_s,
                            chunk_mb=j.request.chunk_mb) for j in rep.jobs]
        su = materialize_jobs(jobs)
        shapes[label] = {"conns": int(su.conn_job.shape[0]),
                         "vms": int(su.vm_eg_cap.shape[0]),
                         "edges": len(su.edges_used),
                         "device_memory": ops.lanes_in_device_memory(
                             -(-su.conn_job.shape[0] // 8) * 8,
                             su.vm_eg_cap.shape[0], len(su.edges_used))}
        shapes[label]["cases"] = hold_sim_kernels(label, su, dev, errs)
    say("service_kernels", shapes=shapes, f64_bitwise=True,
        segsum_bitwise=True, max_abs_err=errs)


def phase_profile(jobs):
    """A steady window of the 1e5-chunk sim's event loop under
    torch.profiler: what the card runs, kernel by kernel. On the card the
    first block of iterations runs eagerly and every later block is a
    replay of its CUDA graph, so the window runs from the first replayed
    water-filling launch (one per iteration) to the last. The profiler's
    records slow the replays, so the window's idle share is the profiled
    run's own, not a run's (``[sim_1e5]`` measures that). The same horizon
    also runs on the card and on the CPU, held equal."""
    from repro_torch.transfer import simulate

    horizon = 40.0  # sim seconds: ~780 iterations, ~12 blocks of 64

    def timed(**kw):
        t0 = time.perf_counter()
        res = simulate(jobs, horizon_s=horizon, **kw)
        if kw.get("device") != "cpu":
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    timed()
    g0 = graph_counts()
    card, card_wall = timed()
    graphs = graph_delta(g0)
    timed(device="cpu")
    cpu, cpu_wall = timed(device="cpu")
    same_run(card, cpu, "1e5 horizon window")
    t0 = time.perf_counter()
    res, dev = profiled(lambda: simulate(jobs, horizon_s=horizon))
    wall = time.perf_counter() - t0
    wf = sorted((s, e) for n, s, e in dev if "waterfill_kernel" in n)
    check(len(wf) > 2 * SIM_BLOCK, "the profiler saw no kernel launched "
          f"from a CUDA graph ({len(wf)} water-filling kernels)")
    lo, hi = wf[SIM_BLOCK][0], wf[-1][1]
    n_it = len(wf) - SIM_BLOCK
    win = [(n, s, e) for n, s, e in dev if s >= lo and e <= hi]
    busy = sum(e - s for _, s, e in win)
    by_name: dict = {}
    for n, s, e in win:
        key = n.split("(")[0].replace("void ", "")[:60]
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    say("profile", sim_events=res.events, loop_iterations=len(wf),
        replayed_iterations=n_it,
        window_us=round(hi - lo, 1), device_busy_us=round(busy, 1),
        device_idle_share_profiled=round(1.0 - busy / (hi - lo), 4),
        device_us_per_iteration=round(busy / n_it, 2),
        launches_per_iteration=round(len(win) / n_it, 1),
        wall_us_per_iteration_profiled=round((hi - lo) / n_it, 1),
        profiled_wall_s=round(wall, 3),
        card_wall_s=card_wall, card_events_per_s=card.events / card_wall,
        card_graphs=graphs,
        cpu_wall_s=cpu_wall, cpu_events_per_s=cpu.events / cpu_wall,
        top_device_us={k: round(v, 1) for k, v in top})


def phase_kernels(shapes, dev, launches, errs):
    from repro_torch.kernels.waterfill import ops, ref

    out, extra = [], {}
    su = shapes["sim"]
    for precision, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        name = f"waterfill_{precision}"
        per_shape = {}
        for label in ("sim", "sim_1e5"):  # the shared-memory kernel's
            args = wf_inputs(shapes[label], dev, dtype)
            segs = ops.build_segments(args["src"], args["dst"], args["eid"],
                                      args["eg_cap"].shape[0],
                                      args["ed_cap"].shape[0])
            kw = dict(args, n_vms=args["eg_cap"].shape[0],
                      n_edges=args["ed_cap"].shape[0])
            if precision == "f64":
                def plain():
                    return ref.masked_maxmin_rates(**kw)
            else:
                n_it = 2 * kw["n_vms"] + kw["n_edges"] + 4
                kw.pop("n_vms"), kw.pop("n_edges")

                def plain():
                    return ref.waterfill_rounds_f32(**kw, n_iters=n_it)

            def kernel():
                return ops.waterfill_rates(**args, precision=precision,
                                           segments=segs)
            got = kernel().cpu()
            want = ops.waterfill_rates(**to_cpu(args), precision=precision)
            errs[name] = max(errs[name], float((got - want).abs().max()))
            rounds, chain = live_rounds(args, precision)
            bound, by = wf_bound(args, rounds, precision)
            ms = kernel_ms(kernel, 50)
            per_shape[label] = dict(
                conns=args["caps"].shape[0], vms=args["eg_cap"].shape[0],
                edges=args["ed_cap"].shape[0], rounds=rounds, chain=chain,
                ms=ms, ns_per_chained_add=ms * 1e6 / max(chain, 1),
                call_ms=cuda_ms(kernel, 200), plain_ms=cuda_ms(plain, 5),
                bound_ms=bound, bound_by=by,
            )
        main = per_shape["sim"]
        out.append(dict(
            name=name, route="cuda", source=WF_SOURCE, replaces=WF_TPU,
            launches=launches[name], max_abs_err=errs[name], ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=None,
            call_ms=main["call_ms"],
        ))
        extra[name] = per_shape
    # the device-memory variant (f64, the sim's solver) at the sim's shape
    # and at the fleet's, where the fleet sim ran it
    per_shape = {}
    for label in ("sim", "fleet"):
        args = wf_inputs(shapes[label], dev, torch.float64)
        nv, ne = args["eg_cap"].shape[0], args["ed_cap"].shape[0]
        segs = ops.build_segments(args["src"], args["dst"], args["eid"], nv,
                                  ne)
        lanes = wf_lanes(args, "f64")
        kw = dict(args, n_vms=nv, n_edges=ne)

        def kernel():
            return ops.waterfill_rates(**args, segments=segs, lanes=lanes)
        got = kernel().cpu()
        want = ops.waterfill_rates(**to_cpu(args))
        check(torch.equal(got, want), f"device-memory variant ({label})")
        rounds, chain = live_rounds(args, "f64")
        bound, by = wf_bound(args, rounds, "f64")
        ms = kernel_ms(kernel, 50)
        per_shape[label] = dict(
            conns=args["caps"].shape[0], vms=nv, edges=ne, rounds=rounds,
            chain=chain, ms=ms, ns_per_chained_add=ms * 1e6 / max(chain, 1),
            call_ms=cuda_ms(kernel, 200),
            plain_ms=cuda_ms(lambda: ref.masked_maxmin_rates(**kw), 3),
            bound_ms=bound, bound_by=by,
        )
    main = per_shape["fleet"]
    out.append(dict(
        name="waterfill_f64_global", route="cuda", source=WF_SOURCE,
        replaces=WF_TPU, launches=launches["waterfill_f64_global"],
        max_abs_err=errs["waterfill_f64_global"], ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None, call_ms=main["call_ms"],
        sim_shape_ms=per_shape["sim"]["ms"],
    ))
    extra["waterfill_f64_global"] = per_shape
    # ordered segment sum at the sim's per-(job, edge) map
    ne = len(su.edges_used)
    je = torch.as_tensor(su.conn_job * ne + su.conn_edge, device=dev)
    nseg = len(su.arrivals) * ne
    lists = ops.csr(je, nseg)
    w = torch.as_tensor(np.random.default_rng(5).uniform(0, 3, je.shape[0]),
                        device=dev)
    n = je.shape[0]
    got = ops.segment_sum_ordered(w, je, nseg, lists=lists).cpu()
    want = ref.segment_sum_ordered(w.cpu(), je.cpu(), nseg)
    errs["segsum_ordered_f64"] = max(errs["segsum_ordered_f64"],
                                     float((got - want).abs().max()))
    nbytes = n * 8 + n * 4 + (nseg + 1) * 4 + nseg * 8
    t_b, t_o = nbytes / HBM_BYTES_S, n / PEAK_OPS["f64"]

    def segsum():
        return ops.segment_sum_ordered(w, je, nseg, lists=lists)

    seg_ms = kernel_ms(segsum, 50)
    # the longest segment's nonzero terms: its chain of dependent adds
    chain = int(np.bincount(je.cpu().numpy()[w.cpu().numpy() != 0]).max())
    out.append(dict(
        name="segsum_ordered_f64", route="cuda", source=WF_SOURCE,
        replaces=SEGSUM_REPLACES, launches=launches["segsum_ordered_f64"],
        max_abs_err=errs["segsum_ordered_f64"],
        ms=seg_ms,
        plain_ms=cuda_ms(lambda: ref.segment_sum_ordered(w, je, nseg), 500),
        bound_ms=max(t_b, t_o) * 1e3,
        bound_by="bytes" if t_b >= t_o else "operations",
        library_ms=cuda_ms(
            lambda: torch.zeros(nseg, dtype=torch.float64, device=dev)
            .index_add_(0, je, w), 500),
        call_ms=cuda_ms(segsum, 500),
    ))
    extra["segsum_ordered_f64"] = {
        "lanes": n, "segments": nseg, "chain": chain,
        "ns_per_chained_add": seg_ms * 1e6 / chain,
    }
    return out, extra


# ------------------------------------------------------------- model path
def flash_inputs(c: dict, dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(heads):
        return torch.randn(c["b"], c["s"], heads, c["d"], generator=g,
                           device="cuda").to(dtype)

    return rn(c["h"]), rn(c["kv"]), rn(c["kv"])


def ssd_inputs(c: dict, dtype, seed: int):
    """x, dt, a, B, C as the reference's kernel tests draw them."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    x = rn(c["b"], c["s"], c["h"], c["p"]).to(dtype)
    dt = torch.nn.functional.softplus(rn(c["b"], c["s"], c["h"]))
    a = -torch.exp(rn(c["h"]) * 0.3)
    return (x, dt, a, rn(c["b"], c["s"], c["n"]).to(dtype),
            rn(c["b"], c["s"], c["n"]).to(dtype))


def flash_bound(c: dict, dtype) -> tuple[float, str]:
    """q, k, v read once and out written once; 4 * D operations per
    (query, visible key) pair (two products), counted over the causal and
    window mask of this shape; f32 inputs at the f32 vector peak, bf16 at
    the bf16 tensor-core peak."""
    e = 2 if dtype == torch.bfloat16 else 4
    b, s, h, kv, d = c["b"], c["s"], c["h"], c["kv"], c["d"]
    nbytes = e * b * s * d * (2 * h + 2 * kv)
    w = c["window"] or s
    pairs = sum(min(i + 1, w) for i in range(s))
    ops = 4 * d * b * h * pairs
    peak = BF16_TENSOR_OPS if dtype == torch.bfloat16 else PEAK_OPS["f32"]
    t_b, t_o = nbytes / HBM_BYTES_S, ops / peak
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def ssd_bound(c: dict, dtype) -> tuple[float, str]:
    """x, dt, a, B, C read once, y and the f32 state written once; per
    (b, h, chunk): C.B and the weighted product with x over the causal
    triangle (2N + 2P + 3 per pair), the carry-in and state products
    (2 * 2PN per step); f32 at the vector peak, bf16 at the tensor-core
    peak."""
    e = 2 if dtype == torch.bfloat16 else 4
    b, s, h, p, n, q = (c[k] for k in "bshpnq")
    s_pad = -(-s // q) * q
    nbytes = (2 * e * b * s * h * p + 4 * b * s * h + 4 * h
              + 2 * e * b * s * n + 4 * b * h * p * n)
    per_chunk = q * (q + 1) // 2 * (2 * n + 2 * p + 3) + q * 4 * p * n
    ops = b * h * (s_pad // q) * per_chunk
    peak = BF16_TENSOR_OPS if dtype == torch.bfloat16 else PEAK_OPS["f32"]
    t_b, t_o = nbytes / HBM_BYTES_S, ops / peak
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def phase_flash(errs):
    """The flash kernels against their plain version on the card, f32 and
    bf16, at every FLASH_CASES and ZOO_FLASH_CASES shape:
    ``flash_attention`` as the model
    calls it (bf16 on the tensor-core kernel, f32 on the vector-unit
    one), and the vector-unit kernel on the bf16 inputs too."""
    from repro_torch.kernels.flash_attention import ops

    out = {}
    for label, c in {**FLASH_CASES, **ZOO_FLASH_CASES}.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(c, dtype, seed=1)
            want = ops.flash_attention_plain(q, k, v, window=c["window"])
            runs = {ops.kernel_for(dtype, c["d"]): ops.flash_attention}
            runs.setdefault("vector", lambda *a, **kw: ops.flash_attention_on(
                "vector", *a, **kw))
            for kernel, fn in runs.items():
                got = fn(q, k, v, window=c["window"])
                check(bool(torch.isfinite(got).all()),
                      f"flash {label} {kernel}: not finite")
                err = float((got.float() - want.float()).abs().max())
                check(err <= FLASH_TOL[dtype],
                      f"flash {label} {dtype} {kernel}: |kernel - plain| "
                      f"{err}")
                name = ("flash_attention" if kernel == "wgmma"
                        or dtype == torch.float32 else "flash_vector_bf16")
                errs[name] = max(errs.get(name, 0.0), err)
                out[f"{label}_{str(dtype)[6:]}_{kernel}"] = err
                del got
            del q, k, v, want
    torch.cuda.empty_cache()
    say("flash", cases=len(out), max_abs_err=out, tol={
        str(k)[6:]: v for k, v in FLASH_TOL.items()})


def timed_turns(fns: dict, reps: dict) -> dict:
    """Device ms per call of each of ``fns`` by ``kernel_ms`` (``reps[name]``
    calls), taken in turns, a b b a, so that drift on the card hits every
    one alike; each is the mean of its two readings."""
    names = list(fns)
    got: dict = {n: [] for n in names}
    for n in names + names[::-1]:
        got[n].append(kernel_ms(fns[n], reps[n]))
    return {n: sum(v) / len(v) for n, v in got.items()}


def phase_flash_times() -> dict:
    """bf16 at every FLASH_CASES shape: the tensor-core kernel, the
    vector-unit kernel on the same inputs, and, where one PyTorch call
    computes the same function, ``scaled_dot_product_attention``, timed in
    turns on one card; each beside its bound. A profiled call shows that
    the tensor-core path launches that kernel and nothing else."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops

    out = {}
    for label, c in FLASH_CASES.items():
        q, k, v = flash_inputs(c, torch.bfloat16, seed=3)
        w = c["window"]
        fns = {
            "wgmma": lambda: ops.flash_attention(q, k, v, window=w),
            "vector": lambda: ops.flash_attention_on("vector", q, k, v,
                                                     window=w),
        }
        if w is None:  # one SDPA call is the same function
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            gqa = {"enable_gqa": True} if c["h"] != c["kv"] else {}
            fns["sdpa"] = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, **gqa)
        ms = timed_turns(fns, {"wgmma": 20, "vector": 2, "sdpa": 20})
        bound, by = flash_bound(c, torch.bfloat16)
        out[label] = dict(
            ms=ms["wgmma"], vector_ms=ms["vector"], sdpa_ms=ms.get("sdpa"),
            bound_ms=bound, bound_by=by, bound_share=bound / ms["wgmma"],
            sdpa_over_kernel=(ms["sdpa"] / ms["wgmma"] if "sdpa" in ms
                              else None))
        if label == "zamba2":
            # the profiler names every PyTorch, cuBLAS or cuDNN kernel; a
            # kernel launched from the port's own libraries is unnamed
            _, dev = profiled(fns["wgmma"])
            named = sorted({n for n, _, _ in dev if n})
            check(not named, f"the tensor-core flash call launched {named}")
            out[label]["profiled_device_events"] = len(dev)
        del q, k, v, fns
        if w is None:
            del qt, kt, vt
    torch.cuda.empty_cache()
    say("flash_times", **out)
    return out


def phase_ssd(errs):
    """The SSD kernels against their plain version on the card, f32 and
    bf16, at every SSD_CASES shape (y and the final state): ``ssd_scan`` as
    the model calls it (bf16 on the tensor-core kernel, which must take
    every bf16 case, f32 on the vector-unit one), and the vector-unit
    kernel on the bf16 inputs too."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.obs.metrics import REGISTRY

    wgmma = REGISTRY.counter("kernels.ssd_scan.wgmma_launches")
    out, absmax = {}, {}
    for label, c in SSD_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(c, dtype, seed=2)
            y0, st0 = ops.ssd_scan_plain(*args, chunk=c["q"])
            want = ops.kernel_for(dtype, c["q"], c["p"], c["n"])
            check(want == ("wgmma" if dtype == torch.bfloat16 else "vector"),
                  f"ssd {label} {dtype}: routed to the {want} kernel")
            runs = {want: ops.ssd_scan}
            runs.setdefault("vector", lambda *a, **kw: ops.ssd_scan_on(
                "vector", *a, **kw))
            for kernel, fn in runs.items():
                w0 = wgmma.value
                y, st = fn(*args, chunk=c["q"])
                check(wgmma.value - w0 == (kernel == "wgmma"),
                      f"ssd {label} {dtype}: the {kernel} call moved the "
                      f"tensor-core count by {wgmma.value - w0}")
                check(bool(torch.isfinite(y).all()
                           and torch.isfinite(st).all()),
                      f"ssd {label} {kernel}: not finite")
                tol = SSD_TOL[dtype]
                torch.testing.assert_close(y.float(), y0.float(), atol=tol,
                                           rtol=tol)
                torch.testing.assert_close(st, st0, atol=tol, rtol=tol)
                err = max(float((y.float() - y0.float()).abs().max()),
                          float((st - st0).abs().max()))
                name = ("ssd_scan" if kernel == "wgmma"
                        or dtype == torch.float32 else "ssd_vector_bf16")
                errs[name] = max(errs.get(name, 0.0), err)
                out[f"{label}_{str(dtype)[6:]}_{kernel}"] = err
                del y, st
            absmax[label] = float(y0.float().abs().max())
            del args, y0, st0
    torch.cuda.empty_cache()
    say("ssd", cases=len(out), max_abs_err=out, plain_y_absmax=absmax,
        tol={str(k)[6:]: v for k, v in SSD_TOL.items()})


def phase_serve():
    """``repro_torch.launch.serve`` as a user runs it, at full width and
    depth; returns its flash launches (27 per prefill: one shared
    attention block after each of 27 groups), those of the tensor-core
    kernel, and serve's numbers."""
    from repro_torch.launch import serve
    from repro_torch.obs.metrics import REGISTRY

    torch.cuda.reset_peak_memory_stats()
    out = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    fl = int(REGISTRY.counter("kernels.flash_attention.launches").value)
    fw = int(REGISTRY.counter(
        "kernels.flash_attention.wgmma_launches").value)
    ss = int(REGISTRY.counter("kernels.ssd_scan.launches").value)
    check(fl == 27, f"prefill launched flash attention {fl} times, not 27")
    check(fw == 27, f"{fw} of the prefill's 27 flash launches took the "
          "tensor-core kernel")
    check(ss == 0, "prefill reached the SSD kernel (the reference's does not)")
    check(out["params"] == 6_751_130_832, "not the full zamba2-7b")
    say("serve", prefill_s=out["prefill_s"], decode_s=out["decode_s"],
        decode_tok_s=out["decode_tok_s"], param_gb=out["param_gb"],
        params=out["params"], max_memory_gb=torch.cuda.max_memory_allocated()
        / 1e9, flash_launches=fl, flash_wgmma_launches=fw, ssd_launches=ss,
        sample_tokens=out["sample_tokens"])
    return fl, fw, out


def zamba_full(use_pallas: bool, dtype: str = "bfloat16"):
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("zamba2-7b"), use_pallas=use_pallas,
                               dtype=dtype)


def zamba_params():
    """Full zamba2-7b parameters and a B 4 x S 4096 batch, from a seed."""
    from repro_torch import models

    cfg = zamba_full(True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_params(cfg, gen, "cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (MODEL_B, MODEL_S),
                                     generator=gen, device="cuda")}
    return params, batch


def phase_forward(params, batch, counters: dict):
    """``forward`` at B 4, S 4096 with the kernels in bf16 (the model's
    type), then in f32 with the kernels (use_pallas True) and with the
    plain path (False: einsum attention, ``ssd_chunked``), same parameters
    and tokens. The counters are zeroed just before the bf16 run and read
    just after it; returns its (flash, tensor-core flash, ssd, tensor-core
    ssd) launches."""
    from repro_torch import models
    from repro_torch.launch.serve import RULES
    from repro_torch.models.model import logits_of
    from repro_torch.obs.metrics import REGISTRY

    res = {}
    for key, c in (("bf16", zamba_full(True)),
                   ("f32", zamba_full(True, "float32")),
                   ("f32_plain", zamba_full(False, "float32"))):
        if key == "bf16":
            for n in counters.values():
                REGISTRY.counter(n).reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = models.forward(c, RULES, params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if key == "bf16":
            fl = int(REGISTRY.counter(counters["flash_attention"]).value)
            fw = int(REGISTRY.counter(counters["flash_wgmma"]).value)
            ss = int(REGISTRY.counter(counters["ssd_scan"]).value)
            sw = int(REGISTRY.counter(counters["ssd_wgmma"]).value)
        check(h.shape == (MODEL_B, MODEL_S, c.d_model)
              and bool(torch.isfinite(h).all()), f"forward {key}: bad hidden")
        res[key] = dict(logits=logits_of(c, params, h[:, -1]), wall_s=wall,
                        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                        hidden=h if key != "bf16" else None)
        del h
    check(fl == 27 and fw == 27 and ss == 81 and sw == 81,
          f"forward launched flash {fl} ({fw} tensor-core) and SSD {ss} "
          f"({sw} tensor-core) times, not 27 (27) and 81 (81)")
    k, p = res["f32"], res["f32_plain"]
    rel_h = float((k["hidden"] - p["hidden"]).abs().max()
                  / p["hidden"].abs().max())
    rel_l = float((k["logits"] - p["logits"]).abs().max()
                  / p["logits"].abs().max())
    check(rel_h <= FORWARD_F32_RTOL and rel_l <= FORWARD_F32_RTOL,
          f"forward f32: kernels vs plain differ by {rel_h} (hidden), "
          f"{rel_l} (logits), relative, > {FORWARD_F32_RTOL}")
    b = res["bf16"]["logits"]
    say("forward", bf16_wall_s=res["bf16"]["wall_s"],
        f32_wall_s=k["wall_s"], f32_plain_wall_s=p["wall_s"],
        bf16_max_memory_gb=res["bf16"]["max_memory_gb"],
        f32_max_memory_gb=k["max_memory_gb"],
        f32_plain_max_memory_gb=p["max_memory_gb"],
        f32_rel_hidden_diff=rel_h, f32_rel_logit_diff=rel_l,
        f32_max_abs_logit_diff=float((k["logits"] - p["logits"]).abs().max()),
        rtol=FORWARD_F32_RTOL,
        f32_logit_absmax=float(p["logits"].abs().max()),
        bf16_vs_f32_plain_max_abs_logit_diff=float(
            (b - p["logits"]).abs().max()),
        argmax_agree_bf16_f32_plain=float(
            (b.argmax(-1) == p["logits"].argmax(-1)).float().mean()),
        flash_launches=fl, flash_wgmma_launches=fw, ssd_launches=ss,
        ssd_wgmma_launches=sw)
    del res
    torch.cuda.empty_cache()
    return fl, fw, ss, sw


def _busy(dev, lo=float("-inf"), hi=float("inf")):
    """Device µs of the profiled events inside [lo, hi], and the top five
    kernel names by device µs."""
    win = [(n, s, e) for n, s, e in dev if s >= lo and e <= hi]
    by_name: dict = {}
    for n, s, e in win:
        key = n.split("(")[0].replace("void ", "")[:60]
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return sum(e - s for _, s, e in win), {k: round(v, 1) for k, v in top}


def phase_serve_profile(params, batch, serve_numbers: dict, cfg=None,
                        name: str = "serve_profile"):
    """Where the serving time goes: one prefill of ``batch`` and four
    greedy steps under torch.profiler, the device time of each by kernel,
    and each idle share against the unprofiled serving run's wall times
    (``serve_numbers``); the prefill's also against a warm unprofiled
    prefill. ``cfg`` is full zamba2-7b unless given."""
    from repro_torch.launch.serve import RULES
    from repro_torch.serve import make_prefill_step, make_serve_step

    t_phase = time.perf_counter()
    cfg = cfg or zamba_full(True)
    prefill_step = make_prefill_step(
        cfg, RULES, t_max=batch["tokens"].shape[1] + 8)
    serve_step = make_serve_step(cfg, RULES)
    # [serve]'s prefill is the process's first; this one runs warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_step(params, batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    (state, logits), dev = profiled(lambda: prefill_step(params, batch))
    p_busy, p_top = _busy(dev)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    tok, state = serve_step(params, state, tok)  # outside the window

    def steps():
        t = tok
        for _ in range(4):
            t, _ = serve_step(params, state, t)

    _, dev = profiled(steps)
    d_busy, d_top = _busy(dev)
    prefill_wall = serve_numbers["prefill_s"] * 1e6
    step_wall = (serve_numbers["decode_s"] / serve_numbers["decode_steps"]
                 * 1e6)
    say(name, phase_s=time.perf_counter() - t_phase,
        prefill_device_us=round(p_busy, 1),
        prefill_idle_share=round(1.0 - p_busy / prefill_wall, 4),
        prefill_warm_s=warm_s,
        prefill_warm_idle_share=round(1.0 - p_busy / (warm_s * 1e6), 4),
        prefill_top_device_us=p_top,
        decode_device_us_per_step=round(d_busy / 4, 1),
        decode_launches_per_step=round(len(dev) / 4, 1),
        decode_idle_share=round(1.0 - d_busy / 4 / step_wall, 4),
        decode_top_device_us=d_top)


def phase_model_cpu():
    """Reduced Zamba2 in f32: the card with its kernels against the CPU
    with the plain versions, same parameters: forward hidden, prefill
    logits and 8 greedy decode steps."""
    from repro_torch import models
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.serve import RULES, generate

    cfg = dataclasses.replace(reduced(get_arch("zamba2-7b")),
                              dtype="float32", use_pallas=True)
    cpu = models.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    card = _to(cpu, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 300),
                         generator=torch.Generator().manual_seed(6))
    h_card = models.forward(cfg, RULES, card, {"tokens": toks.to("cuda")}).cpu()
    h_cpu = models.forward(cfg, RULES, cpu, {"tokens": toks})
    g_card = generate(cfg, card, toks.to("cuda"), 9)
    g_cpu = generate(cfg, cpu, toks, 9)
    d_h = float((h_card - h_cpu).abs().max())
    d_l = float((g_card["logits"].cpu() - g_cpu["logits"]).abs().max())
    same = bool(torch.equal(g_card["tokens"].cpu(), g_cpu["tokens"]))
    check(d_h <= MODEL_CPU_TOL and d_l <= MODEL_CPU_TOL,
          f"card vs CPU: hidden {d_h}, logits {d_l}")
    check(same, "card and CPU greedy tokens differ")
    say("model_cpu", seq=int(toks.shape[1]), decode_steps=8,
        max_abs_hidden_diff=d_h, max_abs_logit_diff=d_l, tol=MODEL_CPU_TOL,
        tokens_equal=same)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)

# ------------------------------------------------------------- the zoo
def flash_counts(counters: dict) -> tuple[int, int]:
    """(flash launches, of them on the tensor-core kernel) so far."""
    from repro_torch.obs.metrics import REGISTRY

    return (int(REGISTRY.counter(counters["flash_attention"]).value),
            int(REGISTRY.counter(counters["flash_wgmma"]).value))


def reset_counts(counters: dict) -> None:
    from repro_torch.obs.metrics import REGISTRY

    for n in counters.values():
        REGISTRY.counter(n).reset()


def moe_cfg(layers: int, **kw):
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(MOE_ARCH), num_layers=layers, **kw)


def phase_serve_moe(counters: dict) -> int:
    """qwen3-moe-30b-a3b at full width, 12 of its 48 layers, served by
    ``launch.serve.generate`` (B 4 x S 4096, 31 greedy steps, bf16, the
    kernels on); the counts are zeroed just before and read just after.
    The prefill's routing gives the share of assignments that capacity
    dropped and the max/mean expert load. Returns the flash launches."""
    from repro_torch import models
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe

    t_phase = time.perf_counter()
    cfg = moe_cfg(MOE_LAYERS, use_pallas=True)
    n_params = models.count_params(cfg)
    check(n_params == MOE_PARAMS, f"qwen3-moe at 12 layers has {n_params}")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_params(cfg, gen, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (ZOO_B, ZOO_S), generator=gen,
                           device="cuda", dtype=torch.int32)
    reset_counts(counters)
    with moe.record_routing() as recs:
        res = generate(cfg, params, tokens, ZOO_DECODE)
    fl, fw = flash_counts(counters)
    res_s = (res["prefill_s"], res["decode_s"])
    check(fl == MOE_LAYERS and fw == MOE_LAYERS,
          f"qwen3-moe prefill launched flash {fl} times ({fw} on the "
          f"tensor-core kernel), not {MOE_LAYERS}")
    check(tuple(res["tokens"].shape) == (ZOO_B, ZOO_DECODE)
          and bool(torch.isfinite(res["logits"]).all()),
          "qwen3-moe serving: bad tokens or logits")
    check(len(recs) == MOE_LAYERS * ZOO_DECODE, f"{len(recs)} MoE calls")
    prefill = recs[:MOE_LAYERS]  # the prefill runs first
    m = cfg.moe
    check(all(r["experts"].shape == (ZOO_B * ZOO_S, m.top_k)
              for r in prefill), "the prefill's routing is not [T, k]")
    dropped = [float(1.0 - r["keep"].float().mean()) for r in prefill]
    load = [torch.bincount(r["experts"].reshape(-1),
                           minlength=m.num_experts).float() for r in prefill]
    steps = ZOO_DECODE - 1
    say("serve_moe", phase_s=time.perf_counter() - t_phase, arch=MOE_ARCH,
        layers=MOE_LAYERS, params=n_params,
        param_gb=n_params * 4 / 1e9, batch=ZOO_B, prompt_len=ZOO_S,
        prefill_s=res["prefill_s"], decode_s=res["decode_s"],
        decode_steps=steps, decode_tok_s=ZOO_B * steps / res["decode_s"],
        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        capacity_slots=moe.capacity(cfg, ZOO_B * ZOO_S),
        assignments=ZOO_B * ZOO_S * m.top_k,
        dropped_share=sum(dropped) / len(dropped),
        dropped_share_by_layer=dropped,
        max_over_mean_load=max(float(c.max() / c.mean()) for c in load),
        flash_launches=fl, flash_wgmma_launches=fw,
        sample_tokens=res["tokens"][0, :16].tolist())
    del res, recs, prefill, load
    phase_serve_profile(params, {"tokens": tokens}, {
        "prefill_s": res_s[0], "decode_s": res_s[1], "decode_steps": steps},
        cfg=cfg, name="serve_moe_profile")
    del params
    torch.cuda.empty_cache()
    return fl


def phase_serve_cli(name: str, argv: list, want_flash: int,
                    want_params: int, counters: dict) -> int:
    """``repro_torch.launch.serve.main(argv)`` as a user runs it (its
    vision tokens or audio frames from its seeded generator); the counts
    are zeroed just before and read just after. Then the same model and
    inputs, drawn again from the same seed, under the profiler
    (``[<name>_profile]``). Returns the flash launches."""
    from repro_torch import models
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(argv)
    torch.cuda.synchronize()
    fl, fw = flash_counts(counters)
    check(fl == want_flash and fw == want_flash,
          f"{name}: prefill launched flash {fl} times ({fw} on the "
          f"tensor-core kernel), not {want_flash}")
    n_params = out["params"]
    check(n_params == want_params, f"{name}: {n_params} params")
    say(name, phase_s=time.perf_counter() - t_phase, arch=out["arch"],
        params=out["params"],
        param_gb=out["param_gb"], extras=out["extras"], batch=out["batch"],
        prompt_len=out["prompt_len"], prefill_s=out["prefill_s"],
        decode_s=out["decode_s"], decode_steps=out["decode_steps"],
        decode_tok_s=out["decode_tok_s"],
        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        flash_launches=fl, flash_wgmma_launches=fw,
        sample_tokens=out["sample_tokens"])
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch(argv[1]), use_pallas=True)
    gen = torch.Generator(device="cuda").manual_seed(0)  # as serve.main
    params = models.init_params(cfg, gen, "cuda")
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (out["batch"], out["prompt_len"]), generator=gen,
        device="cuda", dtype=torch.int32)}
    for key, shape in out["extras"].items():
        batch[key] = torch.randn(shape, generator=gen, device="cuda")
    phase_serve_profile(params, batch, out, cfg=cfg, name=f"{name}_profile")
    del params, batch
    torch.cuda.empty_cache()
    return fl


def routing_ties(card: list, cpu: list, k: int, seq: int) -> dict:
    """Card and CPU routing, call by call (``moe.record_routing`` lists of
    the same runs): the top-k expert sets, then the kept assignments of
    the tokens routed alike. A token routed otherwise must sit at a
    near-tie; returns the tied tokens of each call (by record index) and
    the sequences they touch, and fails past MAX_TIE_SHARE."""
    check(len(card) == len(cpu), "card and CPU made other MoE calls")
    ties, seqs, routed = {}, set(), 0
    for i, (a, b) in enumerate(zip(card, cpu)):
        ea = torch.sort(a["experts"].cpu(), -1).values
        eb = torch.sort(b["experts"], -1).values
        differ = (ea != eb).any(-1)
        p = b["probs"]
        gap = (p[:, k - 1] - p[:, k]) <= NEAR_TIE * p[:, k - 1]
        check(bool(gap[differ].all()), f"MoE call {i}: routing differs off "
              f"a near-tie at tokens {differ.nonzero()[:8].tolist()}")
        same = ~differ
        check(torch.equal(a["keep"].cpu()[same], b["keep"][same]),
              f"MoE call {i}: other capacity drops")
        routed += len(differ)
        if differ.any():
            ties[i] = differ
            t = differ.nonzero()[:, 0]
            seqs |= set((t // seq).tolist() if len(differ) > seq
                        else t.tolist())
    n = sum(int(d.sum()) for d in ties.values())
    check(n <= MAX_TIE_SHARE * routed, f"{n} near-tie tokens of {routed}")
    return {"ties": ties, "seqs": seqs, "tied_tokens": n,
            "routed_tokens": routed}


def zoo_batch(cfg, b: int, s: int, seed: int) -> dict:
    """Tokens, and vision tokens or frames where the model takes them."""
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g)}
    if cfg.is_vlm:
        batch["vision"] = torch.randn(b, cfg.num_vision_tokens, cfg.d_model,
                                      generator=g)
    if cfg.is_enc_dec:
        batch["frames"] = torch.randn(b, cfg.num_frames, cfg.d_model,
                                      generator=g)
    return batch


def card_vs_cpu(cfg, card_params, cpu_params, batch, n_decode: int) -> dict:
    """``forward`` hidden, and ``generate`` (prefill logits, then
    ``n_decode - 1`` greedy steps) on the card and on the CPU, same
    parameters and inputs, with MoE routing recorded on both sides. Rows
    of tokens at a near-tie leave the hidden check; sequences holding one
    leave the logits and tokens checks."""
    from repro_torch import models
    from repro_torch.launch.serve import RULES, generate
    from repro_torch.models import moe

    runs = {}
    for side, params, dev in (("card", card_params, "cuda"),
                              ("cpu", cpu_params, "cpu")):
        b = {k: v.to(dev) for k, v in batch.items()}
        extras = {k: v for k, v in b.items() if k != "tokens"}
        with moe.record_routing() as recs:
            h = models.forward(cfg, RULES, params, b)
            g = generate(cfg, params, b["tokens"], n_decode, extras)
        runs[side] = dict(h=h.detach().cpu(), logits=g["logits"].cpu(),
                          tokens=g["tokens"].cpu(), recs=recs)
    c, p = runs["card"], runs["cpu"]
    bsz, s = batch["tokens"].shape
    out = {"tied_tokens": 0, "routed_tokens": 0, "seqs_left_out": 0}
    rows = torch.ones(bsz * s, dtype=torch.bool)
    seqs = torch.ones(bsz, dtype=torch.bool)
    if cfg.moe is not None:
        r = routing_ties(c["recs"], p["recs"], cfg.moe.top_k, s)
        for i, differ in r["ties"].items():
            if i < cfg.num_layers:  # the forward's calls: one row a token
                rows &= ~differ
        seqs[list(r["seqs"])] = False
        out.update(tied_tokens=r["tied_tokens"],
                   routed_tokens=r["routed_tokens"],
                   seqs_left_out=int((~seqs).sum()),
                   forward_dropped_share=float(1.0 - torch.cat([
                       x["keep"].cpu() for x in c["recs"][:cfg.num_layers]
                   ]).float().mean()))
    hc = c["h"].reshape(bsz * s, -1)[rows]
    hp = p["h"].reshape(bsz * s, -1)[rows]
    out["max_abs_hidden_diff"] = float((hc - hp).abs().max())
    out["max_abs_logit_diff"] = float(
        (c["logits"][:, seqs] - p["logits"][:, seqs]).abs().max())
    out["tokens_equal"] = bool(torch.equal(c["tokens"][seqs],
                                           p["tokens"][seqs]))
    return out


def phase_model_cpu_zoo() -> None:
    """The four reduced zoo configs in f32 (qwen3-moe, mixtral with its
    window of 16 under a 300-token prompt, llama-3.2-vision,
    seamless-m4t): the card with its kernels against the CPU with the
    plain versions, same parameters: forward hidden, prefill logits and 8
    greedy decode steps, MoE routing compared first."""
    from repro_torch import models
    from repro_torch.configs import get_arch, reduced

    t_phase = time.perf_counter()
    res = {}
    for i, arch in enumerate(ZOO_ARCHS):
        cfg = dataclasses.replace(reduced(get_arch(arch)), dtype="float32",
                                  use_pallas=True)
        cpu = models.init_params(cfg, torch.Generator().manual_seed(5 + i),
                                 "cpu")
        r = card_vs_cpu(cfg, _to(cpu, "cuda"), cpu,
                        zoo_batch(cfg, 2, 300, seed=6 + i), 9)
        d_h, d_l = r["max_abs_hidden_diff"], r["max_abs_logit_diff"]
        check(d_h <= MODEL_CPU_TOL and d_l <= MODEL_CPU_TOL,
              f"{arch} card vs CPU: hidden {d_h}, logits {d_l}")
        check(r["tokens_equal"], f"{arch}: card and CPU greedy tokens differ")
        res[arch] = r
    say("model_cpu_zoo", phase_s=time.perf_counter() - t_phase, seq=300,
        decode_steps=8, tol=MODEL_CPU_TOL, **res)


def phase_moe_cpu() -> None:
    """qwen3-moe-30b-a3b at full width (2048 wide, 128 experts top-8),
    2 layers, B 2 x S 256, f32: the card with its kernels against the CPU,
    same parameters (drawn on the card, copied): router top-k sets and
    capacity drops first, then the hidden state and the logits (forward,
    then the prefill and 3 greedy steps)."""
    from repro_torch import models
    from repro_torch.models import moe

    t_phase = time.perf_counter()
    cfg = moe_cfg(MOE_CPU_LAYERS, dtype="float32", use_pallas=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    card = models.init_params(cfg, gen, "cuda")
    cpu = _to(card, "cpu")
    t0 = time.perf_counter()
    r = card_vs_cpu(cfg, card, cpu,
                    zoo_batch(cfg, MOE_CPU_B, MOE_CPU_S, seed=8), 4)
    wall = time.perf_counter() - t0
    d_h, d_l = r["max_abs_hidden_diff"], r["max_abs_logit_diff"]
    check(d_h <= MODEL_CPU_TOL and d_l <= MODEL_CPU_TOL,
          f"qwen3-moe card vs CPU: hidden {d_h}, logits {d_l}")
    check(r["tokens_equal"], "qwen3-moe: card and CPU greedy tokens differ")
    say("moe_cpu", phase_s=time.perf_counter() - t_phase, arch=MOE_ARCH,
        layers=MOE_CPU_LAYERS, batch=MOE_CPU_B,
        seq=MOE_CPU_S, params=models.count_params(cfg),
        capacity_slots=moe.capacity(cfg, MOE_CPU_B * MOE_CPU_S),
        near_tie=NEAR_TIE, tol=MODEL_CPU_TOL, wall_s=wall, **r)
    del card, cpu
    torch.cuda.empty_cache()


def zoo_path(counters: dict) -> dict:
    """The zoo's serving phases, each with its launch counts zeroed just
    before it and read just after, then its card = CPU comparisons;
    returns the flash launches by path."""
    by_path = {
        "serve_moe": phase_serve_moe(counters),
        "serve_vlm": phase_serve_cli("serve_vlm", VLM_ARGS, 32,
                                     9_775_157_248, counters),
        "serve_encdec": phase_serve_cli("serve_encdec", ENCDEC_ARGS, 12,
                                        977_758_208, counters),
    }
    phase_model_cpu_zoo()
    phase_moe_cpu()
    return by_path


def model_kernels(launches: dict, errs: dict, flash_times: dict,
                  flash_by_path: dict):
    """The kernels-line entries of flash attention and the SSD scan at
    Zamba2-7B's shapes in bf16 (the model's activation type). Flash
    attention's kernel, vector-unit and library times are
    ``[flash_times]``'s; the SSD scan's tensor-core and vector-unit kernels
    are timed here in turns on the same inputs. Flash attention's launches
    are those of every model path (``flash_by_path``), all on the
    tensor-core kernel."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    out, bf16 = [], torch.bfloat16
    c = FLASH_CASES["zamba2"]
    q, k, v = flash_inputs(c, bf16, seed=3)
    t = flash_times["zamba2"]
    out.append(dict(
        name="flash_attention", route="cuda", source=FLASH_SOURCE,
        replaces=FLASH_TPU, launches=sum(flash_by_path.values()),
        launches_by_path=flash_by_path,
        max_abs_err=errs["flash_attention"], ms=t["ms"],
        plain_ms=cuda_ms(lambda: flash_ops.flash_attention_plain(q, k, v), 2),
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["sdpa_ms"],
        wgmma_launches=launches["flash_wgmma"] + sum(
            v for k, v in flash_by_path.items() if k != "zamba2"),
        vector_source=FLASH_VECTOR_SOURCE, vector_ms=t["vector_ms"],
    ))
    del q, k, v
    c = SSD_CASES["zamba2"]
    args = ssd_inputs(c, bf16, seed=4)
    bound, by = ssd_bound(c, bf16)
    ms = timed_turns({
        "wgmma": lambda: ssd_ops.ssd_scan(*args),
        "vector": lambda: ssd_ops.ssd_scan_on("vector", *args),
    }, {"wgmma": 20, "vector": 2})
    out.append(dict(
        name="ssd_scan", route="cuda", source=SSD_SOURCE, replaces=SSD_TPU,
        launches=launches["ssd_scan"], max_abs_err=errs["ssd_scan"],
        ms=ms["wgmma"],
        plain_ms=cuda_ms(lambda: ssd_ops.ssd_scan_plain(*args), 2),
        bound_ms=bound, bound_by=by, library_ms=None,
        wgmma_launches=launches["ssd_wgmma"],
        vector_source=SSD_VECTOR_SOURCE, vector_ms=ms["vector"],
        bound_share=bound / ms["wgmma"],
    ))
    del args
    torch.cuda.empty_cache()
    return out


def model_path(errs: dict) -> list:
    """The model path's phases; returns its kernels-line entries."""
    from repro_torch.obs.metrics import REGISTRY

    phase_flash(errs)
    flash_times = phase_flash_times()
    phase_ssd(errs)
    counters = {"flash_attention": "kernels.flash_attention.launches",
                "flash_wgmma": "kernels.flash_attention.wgmma_launches",
                "ssd_scan": "kernels.ssd_scan.launches",
                "ssd_wgmma": "kernels.ssd_scan.wgmma_launches"}
    # ---- the model path: every launch count starts at 0 before each run
    for n in counters.values():
        REGISTRY.counter(n).reset()
    serve_flash, serve_wgmma, serve_numbers = phase_serve()
    params, batch = zamba_params()
    fwd_flash, fwd_wgmma, fwd_ssd, fwd_ssd_wgmma = phase_forward(
        params, batch, counters)
    phase_serve_profile(params, batch, serve_numbers)
    del params, batch
    torch.cuda.empty_cache()
    launches = {"flash_attention": serve_flash + fwd_flash,
                "flash_wgmma": serve_wgmma + fwd_wgmma, "ssd_scan": fwd_ssd,
                "ssd_wgmma": fwd_ssd_wgmma}
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched on the model path")
    phase_model_cpu()
    # ---- the zoo's paths: each phase zeroes the counts just before it
    flash_by_path = {"zamba2": launches["flash_attention"],
                     **zoo_path(counters)}
    return model_kernels(launches, errs, flash_times, flash_by_path)


# ------------------------------------------------------------- train path
def train_cfg(scale: float = 1.0, dtype: str = "bfloat16"):
    """``launch/train.py``'s config: ``scaled_config(arch, scale)`` with
    the loss chunk cut to the sequence, in ``dtype``."""
    from repro_torch.launch.train import scaled_config

    cfg = scaled_config(TRAIN_ARCH, scale)
    return dataclasses.replace(cfg, dtype=dtype,
                               loss_chunk=min(cfg.loss_chunk, TRAIN_S))


def train_opt(steps: int):
    """``launch/train.py``'s optimizer for a run of ``steps`` steps."""
    from repro_torch.train.optimizer import OptConfig

    return OptConfig(warmup_steps=max(steps // 20, 5), total_steps=steps)


def compress_hook(record: dict | None = None):
    """Every gradient leaf through ``compress(..., use_pallas=True)``: the
    quantize and dequantize kernels on the card. ``record`` keeps the
    last gradient tree the hook was given."""
    from repro_torch.transfer.compression import compress
    from repro_torch.tree import tree_map

    def hook(grads):
        if record is not None:
            record["grads"] = grads
        return tree_map(lambda t: compress(t, use_pallas=True), grads)

    return hook


def gradient_like(shapes: dict, seed: int) -> dict:
    """Seeded normal values on the card at the given leaf shapes, with the
    spread of a gradient (std 1e-3)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {k: torch.randn(s, generator=g, device="cuda") * 1e-3
            for k, s in shapes.items()}


def grad_shapes() -> dict:
    """Every parameter leaf of the full config: the gradient the hook gets
    each step."""
    from repro_torch.models import abstract_params
    from repro_torch.models.params import leaves

    return {k: pd.shape for k, pd in leaves(abstract_params(train_cfg()))}


def quant_bounds(sizes: list[int]) -> dict:
    """Least times for one step's compression: quantize reads 4n bytes and
    writes n + 4 n_blocks, dequantize the reverse; ~6 and 2 f32 vector
    operations per value."""
    nb = sum(-(-n // QUANT_BLOCK) for n in sizes)
    n = sum(sizes)
    out = {}
    for name, nbytes, ops in (("quantize_int8", 5 * n + 4 * nb, 6 * n),
                              ("dequantize_int8", 5 * n + 4 * nb, 2 * n)):
        t_b, t_o = nbytes / HBM_BYTES_S, ops / PEAK_OPS["f32"]
        out[name] = (max(t_b, t_o) * 1e3,
                     "bytes" if t_b >= t_o else "operations")
    return out


def _same_quant(x, block: int, label: str, errs: dict) -> None:
    """Kernel against plain version on the card: q, scales and the
    dequantized values bit for bit (q and its values where x is finite:
    the int8 code of a NaN is outside the contract)."""
    from repro_torch.kernels.quantize import ops

    q, s = ops.quantize_int8(x, block=block)
    q0, s0 = ops.quantize_int8_plain(x, block=block)
    back = ops.dequantize_int8(q, s, block=block)
    back0 = ops.dequantize_int8_plain(q0, s0, block=block)
    finite = torch.isfinite(x)
    dq = float((q.int() - q0.int())[finite].abs().max())
    ds = float((s - s0).abs().max())
    dback = float((back - back0)[finite].abs().max())
    errs["quantize_int8"] = max(errs.get("quantize_int8", 0.0), dq, ds)
    errs["dequantize_int8"] = max(errs.get("dequantize_int8", 0.0), dback)
    check(torch.equal(s, s0), f"quantize {label}: scales differ ({ds})")
    check(torch.equal(q[finite], q0[finite]),
          f"quantize {label}: q differs ({dq})")
    check(torch.equal(back[finite], back0[finite]),
          f"dequantize {label}: differs ({dback})")


def phase_quantize(errs: dict) -> dict:
    """The quantize and dequantize kernels against their plain versions
    on the card, bit for bit: every gradient leaf of the full smollm-135m,
    ragged lengths, an all-zero block, half-way ties, bf16 input and a
    NaN block; then their device time for one step's gradient (one launch
    per leaf) beside the bound, the plain versions and, for dequantize,
    ``torch.mul`` of the int8 blocks by their scales. Returns the kernels'
    numbers for the kernels line."""
    from repro_torch.kernels.quantize import ops

    shapes = grad_shapes()
    grads = gradient_like(shapes, seed=8)
    for k, x in grads.items():
        _same_quant(x, QUANT_BLOCK, k, errs)
    g = torch.Generator(device="cuda").manual_seed(9)
    ragged = torch.randn(1000, generator=g, device="cuda")
    _same_quant(ragged, QUANT_BLOCK, "n=1000", errs)
    _same_quant(ragged[:7], 4, "n=7 block 4", errs)
    zero = torch.zeros(3 * QUANT_BLOCK, device="cuda")
    zero[2 * QUANT_BLOCK:] = ragged[:QUANT_BLOCK]
    _same_quant(zero, QUANT_BLOCK, "zero block", errs)
    q, s = ops.quantize_int8(zero)
    check(float(s[0]) == 1.0 and int(q[:QUANT_BLOCK].abs().max()) == 0,
          "an all-zero block must have scale 1 and q 0")
    ties = torch.empty(QUANT_BLOCK, device="cuda").uniform_(-100, 100,
                                                            generator=g)
    ties[:9] = torch.tensor([2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5, -1.5,
                             127.0])
    _same_quant(ties, QUANT_BLOCK, "ties", errs)
    q, s = ops.quantize_int8(ties)
    check(float(s[0]) == 1.0 and q[:9].tolist()
          == [2, -2, 4, -4, 0, 0, 2, -2, 127],
          f"ties must round half to even, got {q[:9].tolist()}")
    embed = next(iter(grads.values()))
    _same_quant(embed.to(torch.bfloat16), QUANT_BLOCK, "bf16", errs)
    nan = ragged.clone()
    nan[300] = float("nan")
    _same_quant(nan, QUANT_BLOCK, "NaN block", errs)
    q, s = ops.quantize_int8(nan)
    check(float(s[1]) == 1.0, "a NaN block's scale must be 1.0, as the "
          "plain version's (NaN > 0 is false)")

    xs = list(grads.values())
    qs = [ops.quantize_int8(x) for x in xs]
    q2d = [torch.nn.functional.pad(q.reshape(-1), (0, (-q.numel())
                                                   % QUANT_BLOCK))
           .reshape(-1, QUANT_BLOCK) for q, _ in qs]
    s2d = [s[:, None] for _, s in qs]
    bounds = quant_bounds([x.numel() for x in xs])
    out = {
        "quantize_int8": dict(
            ms=kernel_ms(lambda: [ops.quantize_int8(x) for x in xs], 20),
            plain_ms=cuda_ms(
                lambda: [ops.quantize_int8_plain(x) for x in xs], 5),
            library_ms=None),
        "dequantize_int8": dict(
            ms=kernel_ms(lambda: [ops.dequantize_int8(q, s)
                                  for q, s in qs], 20),
            plain_ms=cuda_ms(lambda: [ops.dequantize_int8_plain(q, s)
                                      for q, s in qs], 5),
            library_ms=cuda_ms(lambda: [torch.mul(a, b)
                                        for a, b in zip(q2d, s2d)], 20)),
    }
    for name, (bound, by) in bounds.items():
        out[name].update(bound_ms=bound, bound_by=by)
    sizes = {k: int(x.numel()) for k, x in grads.items()}
    say("quantize", leaves=len(sizes), values=sum(sizes.values()),
        bitwise=True, max_abs_err={k: errs[k] for k in out},
        step_ms={k: v["ms"] for k, v in out.items()},
        ms_per_launch={k: v["ms"] / len(xs) for k, v in out.items()},
        plain_ms={k: v["plain_ms"] for k, v in out.items()},
        bound_ms={k: v["bound_ms"] for k, v in out.items()},
        library_ms=out["dequantize_int8"]["library_ms"],
        embed_ms=kernel_ms(lambda: ops.quantize_int8(embed), 20))
    del grads, xs, qs, q2d, s2d, embed
    torch.cuda.empty_cache()
    return out


def _snapshot(tree) -> list:
    from repro_torch.tree import tree_leaves

    return [t.detach().to("cpu", copy=True) for t in tree_leaves(tree)]


def recorded_trainer(cfg, tcfg, **kw):
    """A ``Trainer`` that also keeps host copies of the state it saves at
    the first checkpoint and of every state it restores, and the seconds
    of each checkpoint write."""
    from repro_torch.ckpt import checkpoint as ckpt_mod
    from repro_torch.train.trainer import Trainer

    class Recorded(Trainer):
        def _restore_or_init(self):
            params, opt, step = super()._restore_or_init()
            if step:
                self.restored[step] = _snapshot({"params": params,
                                                 "opt": opt})
            return params, opt, step

    tr = Recorded(cfg, tcfg, **kw)
    tr.saved, tr.restored, tr.write_s = {}, {}, []
    save_async = tr.ckpt.save_async

    def save(step, tree, *, extra=None):
        if step == tcfg.ckpt_every and step not in tr.saved:
            tr.saved[step] = _snapshot(tree)
        save_async(step, tree, extra=extra)

    tr.ckpt.save_async = save
    write = ckpt_mod.save_checkpoint

    def timed_write(*a, **k):
        t0 = time.perf_counter()
        out = write(*a, **k)
        tr.write_s.append(time.perf_counter() - t0)
        return out

    ckpt_mod.save_checkpoint = timed_write
    tr.unpatch = lambda: setattr(ckpt_mod, "save_checkpoint", write)
    return tr


def _by_step(metrics_log: list) -> dict:
    """The loss of each step; a step redone after the restart keeps the
    redone value."""
    return {int(m["step"]): m["loss"] for m in metrics_log}


def phase_train(workdir: Path, counters: dict) -> dict:
    """smollm-135m at full width and depth, trained by the port's
    ``Trainer`` as ``launch/train.py`` builds it (bf16 compute, remat
    "full", batch 8 x 2048, loss chunk 512), with every gradient leaf
    through the int8 kernels, 30 steps, checkpoints every 10 and an
    injected failure at step 17. The kernels' launch counts are zeroed
    just before the run and read just after. Then 5 steps without the
    hook. Returns the numbers and the last gradient tree."""
    from repro_torch.models import count_params
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    cfg = train_cfg()
    check(cfg.num_layers == 30 and cfg.d_model == 576
          and cfg.vocab_size == 49_152 and cfg.remat
          and cfg.remat_policy == "full" and cfg.loss_chunk == 512
          and not cfg.use_pallas, f"not the full smollm-135m: {cfg}")
    n_params = count_params(cfg)
    record: dict = {}
    fail = {TRAIN_FAIL_AT}
    tcfg = TrainerConfig(steps=TRAIN_STEPS, global_batch=TRAIN_B,
                         seq_len=TRAIN_S, ckpt_every=TRAIN_CKPT_EVERY,
                         ckpt_dir=str(workdir / "train"), log_every=1)
    for n in counters.values():
        REGISTRY.counter(n).reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = recorded_trainer(
        cfg, tcfg, opt_cfg=train_opt(TRAIN_STEPS),
        grad_transform=compress_hook(record),
        failure_injector=lambda s: s in fail and not fail.discard(s))
    try:
        res = tr.run()
    finally:
        tr.unpatch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: int(REGISTRY.counter(n).value)
                for k, n in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps_run = len(res["metrics"])
    n_leaves = len(tree_leaves(record["grads"]))
    losses = _by_step(res["metrics"])
    restarts, final_step = res["restarts"], res["final_step"]
    check(restarts == 1 and final_step == TRAIN_STEPS,
          f"restarts {restarts}, final step {final_step}")
    check(sorted(tr.restored) == [TRAIN_CKPT_EVERY],
          f"restored from {sorted(tr.restored)}, not step "
          f"{TRAIN_CKPT_EVERY}")
    saved, restored = tr.saved[TRAIN_CKPT_EVERY], tr.restored[
        TRAIN_CKPT_EVERY]
    check(len(saved) == len(restored) and all(
        torch.equal(a, b) for a, b in zip(saved, restored)),
        "the restored checkpoint differs from the saved state")
    del saved, restored, tr.saved, tr.restored
    check(steps_run == TRAIN_STEPS + TRAIN_FAIL_AT - TRAIN_CKPT_EVERY,
          f"{steps_run} steps run")
    q = TRAIN_STEPS // 4
    first = float(np.mean([losses[s] for s in range(1, q + 1)]))
    last = float(np.mean([losses[s] for s in range(TRAIN_STEPS - q + 1,
                                                   TRAIN_STEPS + 1)]))
    check(all(np.isfinite(list(losses.values()))), "a loss is not finite")
    check(last < first, f"loss did not decrease: {first} -> {last}")
    for k, n in launches.items():
        check(n == n_leaves * steps_run,
              f"{k}: {n} launches, not one per leaf per step "
              f"({n_leaves} x {steps_run})")
    times = [m["step_time_s"] for m in res["metrics"]]
    med = float(np.median(times))
    grads = record.pop("grads")
    hook = compress_hook()
    comp_ms = kernel_ms(lambda: hook(grads), 5)

    # the same trainer without the hook: the compressor's share
    plain = Trainer(cfg, dataclasses.replace(
        tcfg, steps=5, ckpt_every=100, ckpt_dir=str(workdir / "nohook")),
        opt_cfg=train_opt(5))
    no_hook = plain.run()
    med_plain = float(np.median([m["step_time_s"]
                                 for m in no_hook["metrics"]]))
    del plain
    phase_train_profile(cfg, med)
    out = dict(
        params=n_params, tokens_per_step=TRAIN_B * TRAIN_S,
        steps_run=steps_run, restarts=res["restarts"],
        final_step=res["final_step"], median_step_s=med,
        tokens_per_s=TRAIN_B * TRAIN_S / med,
        step_s_min_max=[min(times), max(times)],
        loss_first_quarter=first, loss_last_quarter=last,
        losses=[losses[s] for s in sorted(losses)],
        ckpt_write_s=tr.write_s, peak_memory_gb=peak_gb,
        quantize_launches_per_step=launches["quantize_int8"] / steps_run,
        dequantize_launches_per_step=launches["dequantize_int8"] / steps_run,
        compressor_device_ms_per_step=comp_ms,
        median_step_s_without_hook=med_plain,
        compressor_share_of_step=(med - med_plain) / med,
        straggler_events=res["straggler_events"], wall_s=wall,
    )
    say("train", **out)
    return {"numbers": out, "launches": launches, "grads": grads}


def phase_train_profile(cfg, step_s: float) -> None:
    """Where a training step's time goes: one step of ``make_train_step``
    with the hook (after a warm one) under torch.profiler; its device
    time by kernel, its launches, and the idle share against the
    unprofiled median step of [train]."""
    from repro_torch import convert, models
    from repro_torch.data.pipeline import ShardedTokenPipeline
    from repro_torch.sharding.specs import ShardingRules
    from repro_torch.train import init_opt_state, make_train_step

    step = make_train_step(cfg, ShardingRules(batch=None, fsdp=None, tp=None),
                           train_opt(TRAIN_STEPS),
                           grad_transform=compress_hook())
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_params(cfg, gen, "cuda")
    opt = init_opt_state(params)
    pipe = ShardedTokenPipeline(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S)
    batch = convert.batch_from_numpy(next(pipe), "cuda")
    step(params, opt, batch)
    _, dev = profiled(lambda: step(params, opt, batch))
    busy, top = _busy(dev)
    say("train_profile", device_ms=busy / 1e3, launches=len(dev),
        idle_share=1.0 - busy / 1e6 / step_s, top_device_us=top)
    del params, opt, batch
    torch.cuda.empty_cache()


def phase_ef(tree: dict) -> None:
    """Error feedback over the real gradient tree of [train], 25 steps,
    through the kernels: per leaf the residual stays within two
    quantization steps, and the sum of what was sent is within 1% of
    25 g (the reference's tests at toy size)."""
    from repro_torch.models.params import leaves
    from repro_torch.transfer.compression import (
        compress_with_error_feedback,
        init_error_feedback,
    )

    grads = dict(leaves(tree))
    n = 25
    ef = init_error_feedback(grads)
    total = {k: torch.zeros_like(g) for k, g in grads.items()}
    bound = {k: float(g.abs().max()) * 2.0 / 127.0 + 1e-6
             for k, g in grads.items()}
    worst_res = 0.0
    for _ in range(n):
        sent, ef = compress_with_error_feedback(grads, ef, use_pallas=True)
        for k in grads:
            total[k] += sent[k]
            r = float(ef[k].abs().max()) / bound[k]
            worst_res = max(worst_res, r)
            check(r <= 2.0, f"EF residual of {k}: {r} quantization steps")
    rel = {}
    for k, g in grads.items():
        norm = float(torch.linalg.norm(n * g))
        if norm > 0:
            rel[k] = float(torch.linalg.norm(total[k] - n * g)) / norm
    check(max(rel.values()) < 0.01, f"EF sent signal off by {rel}")
    say("ef", steps=n, leaves=len(grads),
        worst_residual_in_steps=worst_res,
        worst_rel_signal_error=max(rel.values()), rel_signal_error=rel)
    del ef, total, sent
    torch.cuda.empty_cache()


def phase_train_cpu(workdir: Path) -> None:
    """Three steps of the same trainer in f32 with the hook, at
    ``scaled_config(arch, 0.25)``, on the card and on the CPU, from one
    step-0 checkpoint of CPU-drawn parameters (each trainer restores it)
    and the same pipeline batches. Holds the losses (1e-4 relative) and
    the first step's gradients (1e-3 of each leaf's largest value), and
    bounds the final parameters' gap by AdamW's own step (module
    constants); prints each leaf's gap and how many int8 codes of the
    first step's gradients differ."""
    import shutil

    from repro_torch import models
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.kernels.quantize import ops
    from repro_torch.models.params import leaves
    from repro_torch.train import init_opt_state
    from repro_torch.train.optimizer import schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    cfg = train_cfg(0.25, "float32")
    opt = train_opt(TRAIN_CPU_STEPS)
    params = models.init_params(cfg, torch.Generator().manual_seed(12), "cpu")
    state = {"params": params, "opt": init_opt_state(params)}
    names = [k for k, _ in leaves(params)]
    first_g, first_q, losses, final = {}, {}, {}, {}
    for device in ("cuda", "cpu"):
        d = workdir / f"train_{device}"
        shutil.rmtree(d, ignore_errors=True)
        save_checkpoint(d, 0, state,
                        extra={"pipeline": {"next_shard": 0, "epoch": 0}})
        hook = compress_hook()

        def recorded(g, hook=hook, device=device):
            if device not in first_g:
                first_g[device] = [t.cpu() for t in tree_leaves(g)]
                first_q[device] = [ops.quantize_int8(t)[0].cpu()
                                   for t in tree_leaves(g)]
            return hook(g)

        tr = Trainer(cfg, TrainerConfig(
            steps=TRAIN_CPU_STEPS, global_batch=TRAIN_CPU_B,
            seq_len=TRAIN_CPU_S, ckpt_every=100, ckpt_dir=str(d),
            log_every=1), opt_cfg=opt, grad_transform=recorded,
            device=device)
        losses[device] = [m["loss"] for m in tr.run()["metrics"]]
        final[device] = load_checkpoint(d / f"step_{TRAIN_CPU_STEPS:08d}",
                                        state)[0]["params"]
    lc, lg = np.array(losses["cpu"]), np.array(losses["cuda"])
    loss_rel = float(np.abs(lg - lc).max() / np.abs(lc).max())

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    grad_rel = {k: rel(a, b) for k, a, b in zip(names, first_g["cuda"],
                                                 first_g["cpu"])}
    p_card, p_cpu = tree_leaves(final["cuda"]), tree_leaves(final["cpu"])
    param_rel = {k: rel(a, b) for k, a, b in zip(names, p_card, p_cpu)}
    gap = max(float((a - b).abs().max()) for a, b in zip(p_card, p_cpu))
    lr_sum = sum(float(schedule(opt, torch.tensor(t)))
                 for t in range(1, TRAIN_CPU_STEPS + 1))
    q_diff = sum(int((a != b).sum()) for a, b in zip(first_q["cuda"],
                                                      first_q["cpu"]))
    q_total = sum(a.numel() for a in first_q["cpu"])
    check(loss_rel <= TRAIN_CPU_TOL["loss"],
          f"card vs CPU losses differ by {loss_rel} relative")
    check(max(grad_rel.values()) <= TRAIN_CPU_TOL["grads"],
          f"card vs CPU first-step gradients differ: {grad_rel}")
    allowed = TRAIN_CPU_TOL["adam_steps"] * lr_sum
    check(gap <= allowed, f"card vs CPU parameters {gap} apart, more than "
          f"AdamW's steps allow ({allowed})")
    say("train_cpu", params=models.count_params(cfg), steps=TRAIN_CPU_STEPS,
        batch=[TRAIN_CPU_B, TRAIN_CPU_S], losses_card=losses["cuda"],
        losses_cpu=losses["cpu"], max_rel_loss_diff=loss_rel,
        max_rel_grad_diff=max(grad_rel.values()),
        max_abs_param_diff=gap, lr_sum=lr_sum, tol=TRAIN_CPU_TOL,
        rel_param_diff=param_rel, rel_grad_diff=grad_rel,
        first_step_q_differing=q_diff, first_step_q_total=q_total)


def train_path(errs: dict) -> list:
    """The training path's phases; returns its kernels-line entries. The
    checkpoints go to a git-ignored directory of the checkout, removed at
    the end."""
    import shutil

    counters = {"quantize_int8": "kernels.quantize_int8.launches",
                "dequantize_int8": "kernels.dequantize_int8.launches"}
    timing = phase_quantize(errs)
    workdir = ROOT / "_build" / "train_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        # ---- the training path: its launch counts start at 0 in there
        train = phase_train(workdir, counters)
        phase_ef(train.pop("grads"))
        phase_train_cpu(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out = []
    for name, tpu in (("quantize_int8", QUANT_TPU),
                      ("dequantize_int8", DEQUANT_TPU)):
        check(train["launches"][name] > 0,
              f"{name} was not launched on the training path")
        t = timing[name]
        out.append(dict(
            name=name, route="cuda", source=QUANT_SOURCE, replaces=tpu,
            launches=train["launches"][name], max_abs_err=errs[name],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            work=QUANT_WORK,
        ))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase's numbers here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import default_topology
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.transfer.events import materialize_jobs

    dev = torch.device("cuda")
    # f32 products in full f32 (both are the defaults; stated and set)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_build()
    top = default_topology()
    from repro_torch.core import Planner, PlanSpec, direct_plan

    ceiling = direct_plan(top, SRC, DST, FIG6_VOLUME_GB).cost_per_gb * 1.15
    shape_plan = Planner(top).plan(PlanSpec(
        objective="tput_max", src=SRC, dst=DST, cost_ceiling_per_gb=ceiling,
        volume_gb=FIG6_VOLUME_GB, n_samples=8,
    ))
    errs: dict = {}
    fleet_su = materialize_jobs(fleet_jobs(top))
    phase_waterfill({
        "sim": materialize_jobs(fig6_jobs(top, shape_plan)[0]),
        "sim_1e5": materialize_jobs(big_jobs(top)),
    }, dev, errs)
    phase_waterfill_global({
        "sim": materialize_jobs(fig6_jobs(top, shape_plan)[0]),
        "fleet": fleet_su,
    }, dev, errs)

    # ---- the main path: every launch count starts at 0 here
    counters = {
        "waterfill_f64": "kernels.waterfill_f64.launches",
        "waterfill_f32": "kernels.waterfill_f32.launches",
        "waterfill_f64_global": "kernels.waterfill_f64_global.launches",
        "segsum_ordered_f64": "kernels.segsum_ordered.launches",
    }
    for c in counters.values():
        REGISTRY.counter(c).reset()
    plan = phase_plan(top)
    jobs, faults = fig6_jobs(top, plan)
    phase_sim(jobs, faults)
    big = big_jobs(top)
    phase_sim_1e5(big)
    phase_sim_fleet(top)
    launches = {k: int(REGISTRY.counter(c).value) for k, c in counters.items()}
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched on the main path")

    # ---- the service path: every launch count starts at 0 here
    for c in counters.values():
        REGISTRY.counter(c).reset()
    service_reps = service_path(top, counters)
    service_launches = {k: int(REGISTRY.counter(c).value)
                        for k, c in counters.items()}

    # ---- the calibrated path: every launch count starts at 0 here
    for c in counters.values():
        REGISTRY.counter(c).reset()
    cal_reps = calibrated_path(top, counters)
    cal_launches = {k: int(REGISTRY.counter(c).value)
                    for k, c in counters.items()}
    check(cal_launches["segsum_ordered_f64"] > 0 and sum(
        n for k, n in cal_launches.items() if k.startswith("waterfill")) > 0,
        f"the sim's kernels were not launched on the calibrated path: "
        f"{cal_launches}")
    phase_service_kernels({**service_reps, **cal_reps}, dev, errs)

    phase_profile(big)
    sim_shapes = {"sim": materialize_jobs(jobs),
                  "sim_1e5": materialize_jobs(big), "fleet": fleet_su}
    kernels, shapes = phase_kernels(sim_shapes, dev, {
        k: n + service_launches[k] + cal_launches[k]
        for k, n in launches.items()}, errs)
    for k in kernels:
        k["launches_by_path"] = {"sim": launches[k["name"]],
                                 "service": service_launches[k["name"]],
                                 "calibrated": cal_launches[k["name"]]}
    kernels += model_path(errs)
    kernels += train_path(errs)
    line = {"kernels": kernels}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": kernels, "shapes": shapes}, indent=1,
            default=float,
        ))
    say("kernels_by_shape", **shapes)
    print(json.dumps(line, default=float), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
